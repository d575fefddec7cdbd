"""The port's whole detector forward against the JAX forward at B=2, for
BGR uint8 and planar I420 input, on the CPU in float32.

Both packages get the same params (JAX init_params through
params_from_jax) and the same frames. The JAX forward runs op by op, not
under jit: jit fuses the I420 conversion into multiply-adds that round a
share of the pixels to the neighbouring integer, so the jitted reference
differs from its own eager form by one LSB on those pixels (ROADMAP C);
the port matches the eager form exactly. final_valid and final_labels must
be equal; boxes agree to 1e-3 px and probabilities to 1e-5 on valid slots;
the embeddings to 1e-4 of their largest magnitude (float32 sums ordered
differently, amplified through the proposal boxes); invalid slots are 0.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.params import params_from_jax  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import CONFIGS, H, W, close, jax_params  # noqa: E402


def frames(fmt, seed=1):
    rng = np.random.RandomState(seed)
    bgr = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    if fmt == "bgr":
        return bgr
    cv2 = pytest.importorskip("cv2")
    return np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420) for f in bgr])


@pytest.mark.parametrize("fmt", ["bgr", "i420"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name, fmt):
    cfg = CONFIGS[name]()
    jm = jax_model(cfg)
    params = jax_params(jm)
    tm = params_from_jax(params, get_model(cfg))
    imgs = frames(fmt)
    ref = {k: np.asarray(v) for k, v in jm.forward(params, imgs).items()}
    got = {k: v.numpy() for k, v in tm(torch.from_numpy(imgs)).items()}
    assert set(got) == set(ref)
    valid = ref["final_valid"]
    assert valid.any()
    np.testing.assert_array_equal(got["final_valid"], valid)
    np.testing.assert_array_equal(got["final_labels"], ref["final_labels"])
    np.testing.assert_allclose(got["final_boxes"], ref["final_boxes"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["final_probs"], ref["final_probs"],
                               atol=1e-5, rtol=0)
    close(got["pooled_box_feat"], ref["pooled_box_feat"])
    close(got["fpn_box_feat"], ref["fpn_box_feat"])
    assert not got["fpn_box_feat"][~valid].any()
