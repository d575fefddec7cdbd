"""ReID feature extractor: BGR crops -> embedding matrix (port of
object_detection_tracking_tpu/models/reid/extractor.py:105-212).

As the JAX extractor (torchreid feature_extractor.py:121-252): each crop
resized to ``image_size`` (256x128 by default), RGB, ImageNet mean and
std, then the net's no-grad forward in chunks of ``max_batch``. The JAX
extractor pads every chunk to ``max_batch`` so that it compiles once; BN in
eval is per sample, so the port runs each chunk as it is.

The crops are resized on the device, in float32, by ``F.interpolate``
(bilinear, ``align_corners=False``, no antialias): cv2's INTER_LINEAR
geometry, without cv2's rounding of the result to uint8 (ROADMAP C13; the
card may have no cv2). A crop already at ``image_size`` is not resized, so
on that path both packages see the same pixels.

Checkpoints are torchreid ``.pth`` files and keep their torch layouts
(``load_reid_state_dict``); ``state_dict_from_jax`` turns the JAX package's
flat dict (HWIO convs, [in, out] linears) back into one.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .common import ReIDNet
from .densenet_reid import DenseNetReID
from .hacnn_reid import HACNNReID
from .ibn_reid import IBNReID
from .inceptionresnetv2_reid import InceptionResNetV2ReID
from .inceptionv4_reid import InceptionV4ReID
from .mlfn_reid import MLFNReID
from .mobilenetv2 import MobileNetV2ReID
from .mudeep_reid import MuDeepReID
from .nasnet_reid import NASNetAMobileReID
from .osnet import OSNet, OSNetAIN
from .pcb_reid import PCBReID
from .resnet_reid import ResNetReID
from .resnetmid_reid import ResNetMidReID
from .senet_reid import SENetReID
from .shufflenet_reid import ShuffleNetV2ReID
from .shufflenetv1_reid import ShuffleNetV1ReID
from .squeezenet_reid import SqueezeNetReID
from .xception_reid import XceptionReID

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)

MODELS = {name: partial(OSNet, name) for name in (
    "osnet_x1_0", "osnet_x0_75", "osnet_x0_5", "osnet_x0_25",
    "osnet_ibn_x1_0")}
MODELS["osnet_ain_x1_0"] = OSNetAIN
MODELS.update({name: partial(ResNetReID, name) for name in (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext101_32x8d", "resnet50_fc512")})
for _net, _names in (
        (SENetReID, ("se_resnet50", "se_resnet50_fc512", "se_resnet101",
                     "se_resnext50_32x4d", "se_resnext101_32x4d")),
        (IBNReID, ("resnet50_ibn_a", "resnet50_ibn_b")),
        (MobileNetV2ReID, ("mobilenetv2_x1_0", "mobilenetv2_x1_4")),
        (DenseNetReID, ("densenet121", "densenet169", "densenet201",
                        "densenet161", "densenet121_fc512")),
        (SqueezeNetReID, ("squeezenet1_0", "squeezenet1_0_fc512",
                          "squeezenet1_1")),
        (ShuffleNetV2ReID, ("shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
                            "shufflenet_v2_x1_5", "shufflenet_v2_x2_0")),
        (PCBReID, ("pcb_p6", "pcb_p4")),
        (MLFNReID, ("mlfn",)),
        (ResNetMidReID, ("resnet50mid",)),
        (ShuffleNetV1ReID, ("shufflenet",)),
        (HACNNReID, ("hacnn",)),
        (MuDeepReID, ("mudeep",)),
        (XceptionReID, ("xception",)),
        (InceptionV4ReID, ("inceptionv4",)),
        (InceptionResNetV2ReID, ("inceptionresnetv2",)),
        # the reference registry's typo'd key stays an alias
        (NASNetAMobileReID, ("nasnetamobile", "nasnsetmobile"))):
    MODELS.update({name: partial(_net, name) for name in _names})

# models with a hard input-size requirement (an assert in torchreid)
FIXED_IMAGE_SIZE = {"hacnn": (160, 64), "mudeep": (256, 128)}


def check_reid_model(name: str):
    """Raises unless ``name`` is a registry name."""
    if name not in MODELS:
        raise ValueError(f"unknown reid model {name!r}; have {list(MODELS)}")


def build_reid_model(name: str) -> ReIDNet:
    """The net of registry name ``name``, with torchreid's initial
    weights (the current torch seed)."""
    check_reid_model(name)
    return MODELS[name]()


def load_reid_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torchreid checkpoint's state dict, in torch layouts: the
    ``state_dict`` entry when there is one, a leading ``module.``
    (DataParallel) stripped, the training-only ``classifier.*`` dropped."""
    # torchreid checkpoints may hold numpy scalars (rank1), which the
    # weights-only unpickler refuses; the JAX loader reads them the same way
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {}
    for name, t in sd.items():
        if name.startswith("module."):
            name = name[len("module."):]
        if not name.startswith("classifier."):
            out[name] = t
    return out


def state_dict_from_jax(flat: Mapping[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's flat dict (``load_torch_state_dict``: 4-D HWIO,
    depthwise [k, k, 1, C], 2-D [in, out]) as a torch state dict: 4-D back
    to OIHW, 2-D transposed, the rest as it is."""
    out = {}
    for name, arr in flat.items():
        arr = np.asarray(arr)
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        elif arr.ndim == 2:
            arr = arr.T
        out[name] = torch.from_numpy(np.array(arr))   # a C-order copy
    return out


def _device(name: str) -> torch.device:
    """The requested device; a CUDA request without a GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device cuda but torch.cuda.is_available() is False; pass "
            "device='cpu' to run on the CPU")
    return device


class FeatureExtractor:
    """extractor = FeatureExtractor("osnet_x1_0", "osnet.pth")
    feats = extractor(list_of_bgr_crops)  # [N, D] float32 numpy"""

    def __init__(self, model_name: str, model_path: Optional[str] = None,
                 image_size=(256, 128), max_batch: int = 64,
                 compute_dtype: str = "bfloat16", device: str = "cuda"):
        check_reid_model(model_name)
        if not model_path:
            raise ValueError(
                "FeatureExtractor requires model_path (.pth checkpoint); "
                "random-weight mode is not supported for reid models")
        self.device = _device(device)
        self.model_name = model_name
        self.image_size = FIXED_IMAGE_SIZE.get(model_name,
                                               tuple(image_size))  # (h, w)
        self.max_batch = max_batch
        self.dtype = getattr(torch, compute_dtype)
        self.model = MODELS[model_name]()
        self.model.load_state_dict(load_reid_state_dict(model_path))
        self.model.eval().cast(self.dtype).to(
            self.device, memory_format=torch.channels_last)
        dev = dict(device=self.device, dtype=torch.float32)
        self._mean = torch.tensor(_MEAN, **dev)
        self._std = torch.tensor(_STD, **dev)

    def preprocess(self, imgs_bgr: Sequence[np.ndarray]) -> torch.Tensor:
        """uint8 BGR crops [h_i, w_i, 3] -> normalized RGB [N, H, W, 3]
        float32 on the device: one host-to-device copy of all the crops,
        then each crop resized there unless it is at ``image_size``."""
        h, w = self.image_size
        sizes = [im.shape[0] * im.shape[1] * 3 for im in imgs_bgr]
        flat = torch.from_numpy(np.concatenate(
            [np.ascontiguousarray(im).reshape(-1) for im in imgs_bgr]))
        if self.device.type == "cuda":
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        out = torch.empty(len(imgs_bgr), h, w, 3, device=self.device)
        for i, (im, part) in enumerate(zip(imgs_bgr,
                                           flat.split(sizes))):
            x = part.view(im.shape[0], im.shape[1], 3).float()
            if im.shape[:2] != (h, w):
                x = F.interpolate(x.permute(2, 0, 1)[None], size=(h, w),
                                  mode="bilinear", align_corners=False,
                                  antialias=False)[0].permute(1, 2, 0)
            out[i] = x
        rgb = out.flip(-1) / 255.0
        return (rgb - self._mean) / self._std

    @torch.inference_mode()
    def __call__(self, imgs_bgr: Sequence[np.ndarray]) -> np.ndarray:
        if len(imgs_bgr) == 0:
            return np.zeros((0, 1), np.float32)
        x = self.preprocess(imgs_bgr)
        feats = []
        for s in range(0, len(x), self.max_batch):
            chunk = x[s:s + self.max_batch].to(self.dtype).permute(0, 3, 1, 2)
            feats.append(self.model(chunk))
        return torch.cat(feats).cpu().numpy()


def compute_distance_matrix(a: np.ndarray, b: np.ndarray,
                            metric: str = "euclidean") -> np.ndarray:
    """[m, d] x [n, d] -> [m, n] distances (ref torchreid/distance.py:6-67:
    'euclidean' is SQUARED euclidean via the expand trick; 'cosine' is
    1 - cos similarity of L2-normalized rows)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if metric == "euclidean":
        sq_a = (a * a).sum(1, keepdims=True)
        sq_b = (b * b).sum(1, keepdims=True)
        return sq_a + sq_b.T - 2.0 * (a @ b.T)
    if metric == "cosine":
        an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
        bn = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
        return 1.0 - an @ bn.T
    raise ValueError(f"unknown metric {metric!r}")
