"""Multilevel FPN ROIAlign: the plain PyTorch spec and the CUDA kernel's
wrapper (port of object_detection_tracking_tpu/ops/roi_align.py and of the
Pallas kernel ops/pallas/roi_align_pallas.py), and the trainable version
(``multilevel_roi_align_trainable``, JAX roi_align_pallas.py:584-610): the
forward kernel B1 with the backward kernels B1b (the features' gradient)
and B1e (the boxes' gradient), all in csrc/roi_align.cu.

Semantics are exact ``tf.image.crop_and_resize`` fpcoor sampling
(reference nn.py:1229-1335): for output pixel i of a crop of size S over
box [y0, y1] on the ROI's FPN level,

    spacing = (y1 - y0) / S,   y(i) = y0 + spacing * (i + 0.5) - 0.5,

bilinear-interpolated, with samples outside [0, H-1] x [0, W-1] giving 0;
ROIAlign samples at S = 2P and takes the 2x2 mean. The level is the
canonical FPN level of the box (``fpn_map_rois_to_levels``), or the
caller's own per ROI (``levels``, clamped into the levels given, as the
JAX op does): EfficientDet pools each detection from the level of the
anchor that produced it, over five levels P3..P7. The Pallas
kernel demotes elongated boxes to a coarser level only because its fixed
40x48 VMEM window cannot hold them; the CUDA kernel reads device memory
directly, so both versions here keep the canonical level — the semantics
that ``config.roi_align_impl="xla"`` names the exact reference.

Layouts follow the JAX package: features NHWC [B, H_l, W_l, C] per level
(p2..p5, or P3..P7), boxes [B, N, 4] x1y1x2y2 in image coords, valid [B, N] bool,
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


def multilevel_roi_align_vjp(features: Sequence[torch.Tensor],
                             boxes: torch.Tensor, strides: Sequence[int],
                             output_size: int, grad_out: torch.Tensor,
                             levels: Optional[torch.Tensor] = None):
    """The gradient of ``multilevel_roi_align`` (no ``valid``) with respect
    to each feature level, by autograd of the plain version: kernel B1b's
    spec and its CPU path (JAX ``_mra_bwd``, roi_align_pallas.py:600-607,
    without the box gradient). Returns one tensor per level, in that
    level's dtype."""
    with torch.enable_grad():
        feats = [f.detach().requires_grad_(True) for f in features]
        out = multilevel_roi_align(feats, boxes.detach(), strides,
                                   output_size, levels=levels)
        return list(torch.autograd.grad(out, feats, grad_out))


def multilevel_roi_align_box_vjp(features: Sequence[torch.Tensor],
                                 boxes: torch.Tensor, strides: Sequence[int],
                                 output_size: int, grad_out: torch.Tensor,
                                 levels: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The gradient of ``multilevel_roi_align`` (no ``valid``) with respect
    to the boxes, by autograd of the plain version: kernel B1e's spec and
    its CPU path, the box half of the VJP whose feature half is
    ``multilevel_roi_align_vjp`` (JAX gets it from XLA's autodiff of the
    exact gather, ops/roi_align.py:136-181). It flows through the bilinear
    fractions ``iy - floor(iy)`` and ``ix - floor(ix)`` of the in-map
    samples and through the fpcoor grid's linear dependence on the box and
    the level's stride; the level's choice (a floor) and the clipped corner
    indices carry none. Returns float32 [B, N, 4]."""
    with torch.enable_grad():
        bx = boxes.detach().float().requires_grad_(True)
        out = multilevel_roi_align([f.detach() for f in features], bx,
                                   strides, output_size, levels=levels)
        return torch.autograd.grad(out, bx, grad_out)[0]


def roi_tap_footprint(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                      strides: Sequence[int], output_size: int,
                      levels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per ROI, the inclusive rows and columns ``(r0, r1, c0, c1)`` that its
    bilinear taps reach on its level: from the lower neighbour of its first
    in-map sample to the upper neighbour (clamped at H-1, W-1) of its last,
    per axis, in ``multilevel_roi_align``'s float32 sample formula;
    ``(0, -1, 0, -1)`` when no sample on one of the axes lies in the map.
    The plain version of kernel B1b's footprint pass, which decides which
    output tiles an ROI reaches; only the features' shapes are read.
    Returns int64 [B, N, 4]."""
    dev = boxes.device
    lvl = fpn_map_rois_to_levels(boxes) if levels is None else levels
    lvl = lvl.long().clamp(0, len(features) - 1)
    stride = torch.tensor(list(strides), dtype=torch.float32, device=dev)
    h = torch.tensor([f.shape[1] for f in features], device=dev)[lvl]
    w = torch.tensor([f.shape[2] for f in features], device=dev)[lvl]
    fb = boxes / stride[lvl][..., None]

    def span(lo, hi, extent):
        s = _sample_grid(lo, hi, 2 * output_size)
        ext = extent[..., None]
        inside = (s >= 0) & (s <= (ext - 1).float())
        low = torch.minimum(torch.floor(s).long().clamp_min(0), ext - 1)
        first = torch.where(inside, low, ext).amin(-1)
        last = torch.minimum(torch.where(inside, low, -1).amax(-1) + 1,
                             extent - 1)
        return first, last, inside.any(-1)

    r0, r1, in_y = span(fb[..., 1], fb[..., 3], h)
    c0, c1, in_x = span(fb[..., 0], fb[..., 2], w)
    empty = torch.tensor([0, -1, 0, -1], device=dev)
    return torch.where((in_y & in_x)[..., None],
                       torch.stack([r0, r1, c0, c1], -1), empty)


# --------------------------------------------------------------------------
# CUDA kernel wrappers (csrc/roi_align.cu)


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 16 + [_P] * 4 + [_I] * 5 + [_P]
_MAX_LEVELS = 5  # kMaxLevels in csrc
_BWD_ARGTYPES = [_P] * 2 + [_I] * 13 + [_P] * 3 + [_I] * 5 + [_P]
_MAX_POOL = 32   # 2P <= 64 samples per axis: two per lane of a warp
BWD_TILE = (4, 16)   # B1b's output tile, pixels (kTileH, kTileW in csrc)


def _cuda_fn(name: str, argtypes):
    from ..native import load_cuda
    fn = getattr(load_cuda("roi_align"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _cuda_lib():
    """The forward kernel's C entry (tools/torch_roi_align_ab.py swaps it)."""
    return _cuda_fn("roi_align_forward", _ARGTYPES)


def _check_cuda_args(features, boxes, strides, output_size, max_levels):
    """The kernels' shared argument checks; returns (b, n, c, dtype)."""
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if not 1 <= len(features) <= max_levels or len(strides) != len(features):
        raise ValueError(f"the kernel takes 1 to {max_levels} levels and one "
                         f"stride per level, got {len(features)} levels and "
                         f"{len(strides)} strides")
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
    return b, n, c, dtype


def _check_grad_args(kernel, features, boxes, strides, output_size,
                     grad_out, levels):
    """The gradient kernels' (B1b, B1e) argument checks on top of
    ``_check_cuda_args``: four levels, grad_out float32 [B, N, P, P, C] on
    the boxes' device, levels [B, N] there (canonical when None). Returns
    (b, n, c, dtype, contiguous grad_out, int32 levels)."""
    if len(features) != 4:
        raise ValueError(f"{kernel} takes exactly 4 levels (p2..p5), got "
                         f"{len(features)}")
    b, n, c, dtype = _check_cuda_args(features, boxes, strides, output_size,
                                      4)
    p = output_size
    if grad_out.shape != (b, n, p, p, c) or grad_out.dtype != torch.float32 \
            or grad_out.device != boxes.device:
        raise ValueError(f"grad_out must be float32 [B, N, P, P, C] = "
                         f"{(b, n, p, p, c)} on the boxes' device")
    lvl = fpn_map_rois_to_levels(boxes) if levels is None else levels
    if lvl.shape != (b, n) or lvl.device != boxes.device:
        raise ValueError(f"levels must be [B, N] = {(b, n)} on the boxes' "
                         f"device")
    # the kernels clamp the levels into 0..3
    return (b, n, c, dtype, grad_out.contiguous(),
            lvl.to(torch.int32).contiguous())


def multilevel_roi_align_cuda(features: Sequence[torch.Tensor],
                              boxes: torch.Tensor, strides: Sequence[int],
                              output_size: int,
                              valid: Optional[torch.Tensor] = None,
                              levels: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """FPN ROIAlign through the hand-written CUDA kernel; same arguments and
    result as ``multilevel_roi_align``: up to five levels, canonical levels
    or the caller's (``levels`` [B, N], clamped into the levels given by the
    kernel). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel on the current stream (no sync) or raises. Any C is taken: the kernel reads 16 bytes per lane where C is a
    multiple of 8 (bf16) or 4 (float32) and every level starts on 16 bytes,
    and runs its scalar path otherwise (for example a feature view whose
    storage offset leaves it off 16 bytes).
    ``multilevel_roi_align_cuda.launches`` counts the launches."""
    if boxes.device.type == "cpu":
        return multilevel_roi_align(features, boxes, strides, output_size,
                                    valid=valid, levels=levels)
    b, n, c, dtype = _check_cuda_args(features, boxes, strides, output_size,
                                      _MAX_LEVELS)
    if valid is not None and (valid.shape != (b, n)
                              or valid.dtype != torch.bool
                              or valid.device != boxes.device
                              or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous bool [B, N] tensor")
    lvl = fpn_map_rois_to_levels(boxes) if levels is None else levels
    if lvl.shape != (b, n) or lvl.device != boxes.device:
        raise ValueError(f"levels must be [B, N] = {(b, n)} on the boxes' "
                         f"device")
    lvl = lvl.to(torch.int32).contiguous()   # the kernel clamps
    out = torch.empty((b, n, output_size, output_size, c),
                      dtype=torch.float32, device=boxes.device)
    if b * n == 0:
        return out
    pad = _MAX_LEVELS - len(features)
    dims = []
    for f in features:
        dims += [f.shape[1], f.shape[2]]
    with torch.cuda.device(boxes.device):   # the runtime's launch device
        err = _cuda_lib()(
            *[f.data_ptr() for f in features], *[None] * pad, *dims,
            *[0, 0] * pad, *[int(s) for s in strides], *[1] * pad,
            len(features), boxes.data_ptr(), lvl.data_ptr(),
            valid.data_ptr() if valid is not None else None, out.data_ptr(),
            b, n, c, output_size, int(dtype == torch.bfloat16),
            torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: CUDA error {err}")
    multilevel_roi_align_cuda.launches += 1
    return out


multilevel_roi_align_cuda.launches = 0


def multilevel_roi_align_backward_cuda(features: Sequence[torch.Tensor],
                                       boxes: torch.Tensor,
                                       strides: Sequence[int],
                                       output_size: int,
                                       grad_out: torch.Tensor,
                                       levels: Optional[torch.Tensor] = None):
    """The gradient of the ROIAlign forward (no ``valid``) with respect to
    each feature level through the hand-written CUDA kernel B1b; same
    arguments and result as ``multilevel_roi_align_vjp``. A CPU tensor takes
    that plain version; a CUDA tensor launches the kernel on the current
    stream (a plan: the ROIs' tap footprints and the output tiles, most
    ROIs first; then one block per output tile that accumulates in shared
    memory and writes the tile once in the features' dtype; no sync) or
    raises. Bitwise the same from run to run.
    ``multilevel_roi_align_backward_cuda.launches`` counts the launches."""
    if boxes.device.type == "cpu":
        return multilevel_roi_align_vjp(features, boxes, strides, output_size,
                                        grad_out, levels=levels)
    b, n, c, dtype, grad_out, lvl = _check_grad_args(
        "the backward kernel (B1b)", features, boxes, strides, output_size,
        grad_out, levels)
    p = output_size
    sizes = [b * f.shape[1] * f.shape[2] * c for f in features]
    out = torch.empty(sum(sizes), dtype=dtype, device=boxes.device)
    grads = [g.view(f.shape) for g, f in zip(out.split(sizes), features)]
    if out.numel() == 0:
        return grads
    # the kernel's scratch: each ROI's footprint (4 int32), the order of the
    # (image, tile) pairs, and a work queue
    th, tw = BWD_TILE
    pairs = b * sum(-(-f.shape[1] // th) * -(-f.shape[2] // tw)
                    for f in features)
    scratch = torch.empty(4 * b * n + pairs + 1, dtype=torch.int32,
                          device=boxes.device)
    dims = []
    for f in features:
        dims += [f.shape[1], f.shape[2]]
    with torch.cuda.device(boxes.device):
        err = _cuda_fn("roi_align_backward", _BWD_ARGTYPES)(
            out.data_ptr(), scratch.data_ptr(), scratch.numel(), *dims,
            *[int(s) for s in strides], boxes.data_ptr(), lvl.data_ptr(),
            grad_out.data_ptr(), b, n, c, p, int(dtype == torch.bfloat16),
            torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"roi_align backward kernel launch failed: CUDA error {err}")
    multilevel_roi_align_backward_cuda.launches += 1
    return grads


multilevel_roi_align_backward_cuda.launches = 0

_BOX_ARGTYPES = [_P] * 4 + [_I] * 12 + [_P] * 4 + [_I] * 5 + [_P]


def multilevel_roi_align_box_grad_cuda(features: Sequence[torch.Tensor],
                                       boxes: torch.Tensor,
                                       strides: Sequence[int],
                                       output_size: int,
                                       grad_out: torch.Tensor,
                                       levels: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """The gradient of the ROIAlign forward (no ``valid``) with respect to
    the boxes through the hand-written CUDA kernel B1e; same arguments and
    result as ``multilevel_roi_align_box_vjp``. A CPU tensor takes that
    plain version; a CUDA tensor launches the kernel on the current stream
    (one block per ROI; no sync, no scratch) or raises. Bitwise the same
    from run to run. ``multilevel_roi_align_box_grad_cuda.launches`` counts
    the launches."""
    if boxes.device.type == "cpu":
        return multilevel_roi_align_box_vjp(features, boxes, strides,
                                            output_size, grad_out,
                                            levels=levels)
    b, n, c, dtype, grad_out, lvl = _check_grad_args(
        "the box-gradient kernel (B1e)", features, boxes, strides,
        output_size, grad_out, levels)
    p = output_size
    out = torch.empty((b, n, 4), dtype=torch.float32, device=boxes.device)
    if b * n == 0:
        return out
    dims = []
    for f in features:
        dims += [f.shape[1], f.shape[2]]
    with torch.cuda.device(boxes.device):
        err = _cuda_fn("roi_align_box_grad", _BOX_ARGTYPES)(
            *[f.data_ptr() for f in features], *dims,
            *[int(s) for s in strides], boxes.data_ptr(), lvl.data_ptr(),
            grad_out.data_ptr(), out.data_ptr(), b, n, c, p,
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"roi_align box-gradient kernel launch failed: CUDA error {err}")
    multilevel_roi_align_box_grad_cuda.launches += 1
    return out


multilevel_roi_align_box_grad_cuda.launches = 0


class _TrainableROIAlign(torch.autograd.Function):
    """Forward through ``multilevel_roi_align_cuda`` (B1), backward through
    ``multilevel_roi_align_backward_cuda`` (B1b) and, for boxes that
    require grad, ``multilevel_roi_align_box_grad_cuda`` (B1e), all looked
    up at call time; each takes its plain version for CPU tensors."""

    @staticmethod
    def forward(ctx, boxes, strides, output_size, *features):
        levels = fpn_map_rois_to_levels(boxes)
        ctx.save_for_backward(boxes, levels, *features)
        ctx.strides, ctx.output_size = strides, output_size
        return multilevel_roi_align_cuda(list(features), boxes, strides,
                                         output_size, levels=levels)

    @staticmethod
    def backward(ctx, grad_out):
        boxes, levels, *features = ctx.saved_tensors
        grads = multilevel_roi_align_backward_cuda(
            features, boxes, ctx.strides, ctx.output_size, grad_out,
            levels=levels)
        grad_boxes = None
        if ctx.needs_input_grad[0]:
            grad_boxes = multilevel_roi_align_box_grad_cuda(
                features, boxes, ctx.strides, ctx.output_size, grad_out,
                levels=levels)
        return (grad_boxes, None, None, *grads)


def multilevel_roi_align_trainable(features: Sequence[torch.Tensor],
                                   boxes: torch.Tensor,
                                   strides: Sequence[int],
                                   output_size: int) -> torch.Tensor:
    """Differentiable FPN ROIAlign (JAX ``multilevel_roi_align_trainable``,
    roi_align_pallas.py:584-610): the same result as
    ``multilevel_roi_align`` without ``valid``, with gradients to the
    features and, where the boxes require grad, to the boxes. On CUDA
    tensors the forward is kernel B1, the features' gradient kernel B1b and
    the boxes' kernel B1e; on CPU tensors all are the plain version and
    its autograd.

    The box head's and the mask head's boxes come detached (the proposals
    are cut by ``stop_gradient``, JAX faster_rcnn.py:735, and the gt rows
    are inputs), so their launches compute no box gradient. The
    small-object heads pool boxes decoded from the box head's output, and
    JAX's autodiff takes the loss's gradient back through them: there B1e
    runs after B1b."""
    return _TrainableROIAlign.apply(boxes, tuple(int(s) for s in strides),
                                    output_size, *features)
