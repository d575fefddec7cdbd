"""Multilevel FPN ROIAlign: the plain PyTorch spec and the CUDA kernel's
wrapper (port of object_detection_tracking_tpu/ops/roi_align.py and of the
Pallas kernel ops/pallas/roi_align_pallas.py).

Semantics are exact ``tf.image.crop_and_resize`` fpcoor sampling
(reference nn.py:1229-1335): for output pixel i of a crop of size S over
box [y0, y1] on the ROI's FPN level,

    spacing = (y1 - y0) / S,   y(i) = y0 + spacing * (i + 0.5) - 0.5,

bilinear-interpolated, with samples outside [0, H-1] x [0, W-1] giving 0;
ROIAlign samples at S = 2P and takes the 2x2 mean. The level is the
canonical FPN level of the box (``fpn_map_rois_to_levels``). The Pallas
kernel demotes elongated boxes to a coarser level only because its fixed
40x48 VMEM window cannot hold them; the CUDA kernel reads device memory
directly, so both versions here keep the canonical level — the semantics
that ``config.roi_align_impl="xla"`` names the exact reference.

Layouts follow the JAX package: features NHWC [B, H_l, W_l, C] per level
(p2..p5), boxes [B, N, 4] x1y1x2y2 in image coords, valid [B, N] bool,
output [B, N, P, P, C] float32, with invalid slots exactly 0.

Divisions by constants go through a 0-dim tensor on the operands' device:
on CUDA, PyTorch turns division by a Python scalar into multiplication by
its reciprocal, which rounds differently from the kernel's IEEE division
and could move a sample across the in-image boundary.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

_LOG2 = math.log(2.0)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE x / c on every device (see module note)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def fpn_map_rois_to_levels(boxes: torch.Tensor) -> torch.Tensor:
    """FPN level id (0..3 for p2..p5) per box [..., 4] by the sqrt-area
    heuristic, in the JAX op's float32 formula (ops/roi_align.py:115-121,
    reference models.py:440-460). Returns int32 [...]."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    sqrtarea = torch.sqrt(area.clamp_min(0.0))
    lvl = torch.floor(4.0 + _div(torch.log(_div(sqrtarea, 224.0) + 1e-6),
                                 _LOG2))
    return lvl.to(torch.int32).clamp(2, 5) - 2


def _sample_grid(lo: torch.Tensor, hi: torch.Tensor, size: int
                 ) -> torch.Tensor:
    """fpcoor sample coordinates along one axis: [...] -> [..., size]."""
    spacing = _div(hi - lo, float(size))
    i = torch.arange(size, dtype=torch.float32, device=lo.device)
    return lo[..., None] + spacing[..., None] * (i + 0.5) - 0.5


def _bilinear_gather(flat: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                     h: torch.Tensor, w: torch.Tensor, row_offset: torch.Tensor,
                     w_stride: torch.Tensor) -> torch.Tensor:
    """Bilinear samples from a flat [ROWS, C] buffer in which pixel (y, x)
    of a ROI's map lives at row ``row_offset + y * w_stride + x``; h, w are
    the float extents for the out-of-range rule (JAX ops/roi_align.py:36-72).
    """
    in_range = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
    y0f = torch.floor(iy)
    x0f = torch.floor(ix)
    fy = (iy - y0f)[..., None]
    fx = (ix - x0f)[..., None]
    hi_y = (h - 1).long()
    hi_x = (w - 1).long()
    zero = torch.zeros((), dtype=torch.long, device=iy.device)
    y0 = torch.minimum(torch.maximum(y0f.long(), zero), hi_y)
    x0 = torch.minimum(torch.maximum(x0f.long(), zero), hi_x)
    y1 = torch.minimum(y0 + 1, hi_y)
    x1 = torch.minimum(x0 + 1, hi_x)

    def g(y, x):
        idx = row_offset + y * w_stride + x
        return flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (flat.shape[-1],))

    top = g(y0, x0) * (1 - fx) + g(y0, x1) * fx
    bot = g(y1, x0) * (1 - fx) + g(y1, x1) * fx
    out = top * (1 - fy) + bot * fy
    return torch.where(in_range[..., None], out, torch.zeros_like(out))


def multilevel_roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                         strides: Sequence[int], output_size: int,
                         valid: Optional[torch.Tensor] = None,
                         levels: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch FPN ROIAlign over the batch — the kernel's spec and the
    CPU path (JAX ops/roi_align.py:136-181 under vmap, plus the ``valid``
    masking of faster_rcnn.py:451-490). features: list of [B, H_l, W_l, C]
    (any float dtype; sampled in f32); boxes [B, N, 4] image coords;
    levels: optional [B, N] source level per ROI. Returns [B, N, P, P, C]
    float32."""
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    n_levels = len(features)
    dev = boxes.device
    lvl = fpn_map_rois_to_levels(boxes) if levels is None else levels
    lvl = lvl.long().clamp(0, n_levels - 1)

    # all levels in one flat [sum_l B*H_l*W_l, C] f32 buffer: pixel (y, x)
    # of image i on level l sits at base_l + i*H_l*W_l + y*W_l + x
    flat = torch.cat([f.float().reshape(-1, c) for f in features])
    hw = [f.shape[1] * f.shape[2] for f in features]
    base = torch.tensor([0] + [b * s for s in hw[:-1]], device=dev).cumsum(0)
    hw_t = torch.tensor(hw, device=dev)
    h_int = torch.tensor([f.shape[1] for f in features], device=dev)
    w_int = torch.tensor([f.shape[2] for f in features], device=dev)
    stride = torch.tensor(list(strides), dtype=torch.float32, device=dev)

    fb = boxes / stride[lvl][..., None]
    size2 = output_size * 2
    iy = _sample_grid(fb[..., 1], fb[..., 3], size2)[..., :, None]
    ix = _sample_grid(fb[..., 0], fb[..., 2], size2)[..., None, :]
    iy = iy.expand(b, n, size2, size2)
    ix = ix.expand(b, n, size2, size2)
    img = torch.arange(b, device=dev)[:, None]
    row_offset = (base[lvl] + img * hw_t[lvl])[..., None, None]
    crop = _bilinear_gather(
        flat, iy, ix, h_int[lvl].float()[..., None, None],
        w_int[lvl].float()[..., None, None], row_offset,
        w_int[lvl][..., None, None])
    out = crop.reshape(b, n, output_size, 2, output_size, 2, c).mean(
        dim=(3, 5))
    if valid is not None:
        out = torch.where(valid[:, :, None, None, None], out,
                          torch.zeros_like(out))
    return out


# --------------------------------------------------------------------------
# CUDA kernel wrapper (csrc/roi_align.cu)


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 12 + [_P] * 4 + [_I] * 5 + [_P]
_MAX_POOL = 32   # 2P <= 64 samples per axis: two per lane of a warp


def _cuda_lib():
    from ..native import load_cuda
    lib = load_cuda("roi_align")
    fn = lib.roi_align_forward
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def multilevel_roi_align_cuda(features: Sequence[torch.Tensor],
                              boxes: torch.Tensor, strides: Sequence[int],
                              output_size: int,
                              valid: Optional[torch.Tensor] = None,
                              levels: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """FPN ROIAlign through the hand-written CUDA kernel; same arguments and
    result as ``multilevel_roi_align``. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel on the current stream (no sync) or
    raises. Any C is taken: the kernel reads 16 bytes per lane where C is a
    multiple of 8 (bf16) or 4 (float32) and every level starts on 16 bytes,
    and runs its scalar path otherwise (for example a feature view whose
    storage offset leaves it off 16 bytes).
    ``multilevel_roi_align_cuda.launches`` counts the launches."""
    if boxes.device.type == "cpu":
        return multilevel_roi_align(features, boxes, strides, output_size,
                                    valid=valid, levels=levels)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if len(features) != 4 or len(strides) != 4:
        raise ValueError("the kernel takes exactly 4 FPN levels (p2..p5)")
    if not 1 <= output_size <= _MAX_POOL:
        raise ValueError(f"output_size {output_size} outside 1..{_MAX_POOL}")
    b, n = boxes.shape[:2]
    if boxes.shape != (b, n, 4) or boxes.dtype != torch.float32 \
            or not boxes.is_contiguous():
        raise ValueError("boxes must be contiguous float32 [B, N, 4]")
    dtype = features[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feature dtype {dtype} is not float32/bfloat16")
    c = features[0].shape[-1]
    for f in features:
        if (f.device != boxes.device or f.dtype != dtype or f.dim() != 4
                or f.shape[0] != b or f.shape[-1] != c
                or not f.is_contiguous()):
            raise ValueError(
                "features must be contiguous NHWC [B, H_l, W_l, C] tensors "
                "of one dtype on the boxes' device")
    if valid is not None and (valid.shape != (b, n)
                              or valid.dtype != torch.bool
                              or valid.device != boxes.device
                              or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous bool [B, N] tensor")
    lvl = fpn_map_rois_to_levels(boxes) if levels is None else levels
    lvl = lvl.to(torch.int32).clamp(0, 3).contiguous()
    out = torch.empty((b, n, output_size, output_size, c),
                      dtype=torch.float32, device=boxes.device)
    if b * n == 0:
        return out
    dims = []
    for f in features:
        dims += [f.shape[1], f.shape[2]]
    err = _cuda_lib()(
        *[f.data_ptr() for f in features], *dims, *[int(s) for s in strides],
        boxes.data_ptr(), lvl.data_ptr(),
        valid.data_ptr() if valid is not None else None, out.data_ptr(),
        b, n, c, output_size, int(dtype == torch.bfloat16),
        torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: CUDA error {err}")
    multilevel_roi_align_cuda.launches += 1
    return out


multilevel_roi_align_cuda.launches = 0
