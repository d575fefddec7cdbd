"""The port's greedy NMS through its custom op ``odt::greedy_keep``
(object_detection_tracking_tpu_torch/ops/nms.py) on the CPU, where the op
runs the plain Jacobi fixpoint (kernel N1's spec), against the JAX
package's ``nms`` and ``_greedy_keep`` on the cases greedy NMS most easily
gets wrong: tied scores and repeated boxes, all boxes overlapping, groups
with no valid box, N on, just over and off a multiple of 64 (N1's word
size) and N = 1, boxes that never overlap, zero-area and repeated zero-area
boxes (union 0), a negative threshold (0 > thres: every pair suppresses),
and IOUs on the threshold's float32 value and its neighbours (the
comparison is strict and in float32). Indices, validity and keep masks
must be equal. Then torch.export holds the op as one node and no host
sync. Kernel N1 is held against this plain version, bit for bit, on the
card
(tests/test_torch_kernels_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_tracking_tpu.ops.nms import _greedy_keep as jax_keep
from object_detection_tracking_tpu.ops.nms import nms as jax_nms
from object_detection_tracking_tpu_torch.ops import nms as N
from torch_nms_cases import CASES, make_case, threshold_pairs
from torch_port_common import one_torch_thread  # noqa: F401

_jax_keep = jax.jit(jax_keep, static_argnums=2)


@pytest.mark.parametrize("name", CASES)
def test_nms_op_matches_jax(name):
    b, s, v, thres, max_out = make_case(name)
    got_i, got_v = N.nms(torch.from_numpy(b), torch.from_numpy(s), max_out,
                         thres, valid=torch.from_numpy(v))
    order = np.argsort(-np.where(v, s, -1e30), axis=-1, kind="stable")
    bs = np.take_along_axis(b, order[..., None], 1)
    vs = np.take_along_axis(v, order, 1)
    keep = N._greedy_keep(torch.from_numpy(bs), torch.from_numpy(vs), thres)
    for g in range(b.shape[0]):
        ref_i, ref_v = jax_nms(jnp.asarray(b[g]), jnp.asarray(s[g]), max_out,
                               thres, valid=jnp.asarray(v[g]))
        np.testing.assert_array_equal(got_i[g].numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(got_v[g].numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(
            keep[g].numpy(), np.asarray(_jax_keep(jnp.asarray(bs[g]),
                                                  jnp.asarray(vs[g]), thres)))
    if name == "all_invalid":
        assert not got_v[0].any() and got_v[2].sum() == 1
    if name == "disjoint":
        assert torch.equal(keep, torch.from_numpy(vs))   # nothing overlaps
    if name == "degenerate":
        # a zero-area box's IOU is 0 with every box: never suppressed
        flat = (bs[..., 2] == bs[..., 0]) | (bs[..., 3] == bs[..., 1])
        assert flat.sum() > 100 and keep.numpy()[flat & vs].all()
    if name == "negative_threshold":
        assert keep.sum(-1).tolist() == [1, 1, 1]        # 0 > thres
        assert keep.numpy()[np.arange(3), vs.argmax(-1)].all()
    if name.startswith("threshold"):
        # IOU just under and on the threshold keeps both; just over drops
        # the second (the comparison is strict, in float32)
        assert keep.numpy().tolist() == [[True, True], [True, True],
                                         [True, False]]


@pytest.mark.parametrize("thres", [0.7, 0.5, 0.3])
def test_threshold_pairs_hit_the_float32_threshold(thres):
    boxes = threshold_pairs(thres)
    from object_detection_tracking_tpu_torch.ops.boxes import pairwise_iou
    iou = pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes))
    got = iou[:, 0, 1].numpy()
    t = np.float32(thres)
    assert got.tolist() == [np.nextafter(t, np.float32(0)), t,
                            np.nextafter(t, np.float32(1))]


def test_export_holds_greedy_keep_as_one_node():
    class Nms(torch.nn.Module):
        def forward(self, boxes, scores, valid):
            return N.nms(boxes, scores, 16, 0.5, valid=valid)

    b, s, v, _, _ = make_case("n130")
    args = tuple(torch.from_numpy(x) for x in (b, s, v))
    ep = torch.export.export(Nms(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("odt.greedy_keep.default") == 1
    assert not [t for t in targets if "aten.equal" in t
                or "aten._local_scalar_dense" in t]
    got = ep.module()(*args)
    ref = Nms()(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
