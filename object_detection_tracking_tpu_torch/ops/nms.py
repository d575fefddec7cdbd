"""Exact greedy NMS with static padded outputs (port of
object_detection_tracking_tpu/ops/nms.py).

Same formulation as the JAX op, batched over any leading dims:

  1. sort candidates by score, stable, so the lower index wins ties (TF's
     top_k tie-breaking, which downstream matching depends on);
  2. build ``m[j, i] = IOU(j, i) > thres`` (strict) for j earlier than i;
  3. solve ``keep[i] = valid[i] & ~OR_j<i(keep[j] & m[j, i])`` by Jacobi
     fixpoint iteration. After t steps the first t sorted positions are
     final, and the only fixed point is the greedy solution, so stopping at
     a fixed point is exact.

Step 3 is the custom op ``odt::greedy_keep`` (``_greedy_keep``), so that
torch.export holds it as one node and a CUDA graph can capture it. On a CPU
tensor it runs the fixpoint above (``greedy_keep_plain``, the spec), which
checks convergence on the host every ``_CHECK_EVERY`` steps; on a CUDA
tensor it launches kernel N1 (``greedy_keep_cuda``, csrc/nms.cu), which
computes the same unique solution on the device with no host sync, the
counterpart of JAX's ``lax.while_loop`` (JAX ops/nms.py:33-53).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .boxes import pairwise_iou
from .roi_align import _launch_env

_NEG_INF = -1e30
_CHECK_EVERY = 4


def sort_desc_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Top-k along the last dim, descending, lower index first on ties —
    ``jax.lax.top_k``'s order, which ``torch.topk`` does not promise."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def greedy_keep_plain(boxes_sorted: torch.Tensor,
                      valid_sorted: torch.Tensor,
                      iou_thres: float) -> torch.Tensor:
    """The greedy keep mask [..., N] of score-sorted boxes [..., N, 4] by
    the Jacobi fixpoint (module note): kernel N1's spec and CPU path."""
    n = boxes_sorted.shape[-2]
    iou = pairwise_iou(boxes_sorted, boxes_sorted)
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=boxes_sorted.device).triu(1)   # j < i
    suppress = (iou > iou_thres) & earlier
    suppress &= valid_sorted[..., :, None] & valid_sorted[..., None, :]
    keep = valid_sorted
    while True:
        prev = keep
        for _ in range(_CHECK_EVERY):
            keep = valid_sorted & ~(suppress & keep[..., :, None]).any(-2)
        if torch.equal(keep, prev):
            return keep


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 3 + [_I, _I, ctypes.c_float, _P]
# the most boxes a group kernel N1 takes (one CTA's shared memory holds
# them: csrc/nms.cu kMaxN)
MAX_BOXES = 8192


def _lib():
    """csrc/nms.cu's library, built at first use, its entries typed."""
    from ..native import load_cuda
    lib = load_cuda("nms")
    if lib.nms_keep.argtypes is None:
        lib.nms_keep.argtypes = _ARGTYPES
        lib.nms_keep.restype = ctypes.c_int
        lib.nms_plan.argtypes = [_I, _I, _P]
        lib.nms_plan.restype = ctypes.c_int
    return lib


def greedy_keep_plan(groups: int, n: int, device=None) -> dict:
    """The launch kernel N1 makes on ``device`` (a card) for ``groups``
    groups of ``n`` boxes: the cluster size (CTAs a group), the CTAs, the
    threads and the shared bytes of a CTA (csrc/nms.cu's regime)."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = _lib().nms_plan(groups, n, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"nms_plan failed: CUDA error {err}")
    return dict(zip(("cluster", "ctas", "threads", "smem"), out))


def greedy_keep_cuda(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                     iou_thres: float) -> torch.Tensor:
    """``greedy_keep_plain``'s result through the hand-written kernel N1
    (csrc/nms.cu): a CPU tensor takes the plain version; a CUDA tensor
    launches the kernel once on the current stream (a CTA, or a cluster
    of CTAs, a group; only ``keep`` is allocated), with no sync, or
    raises. Bit-equal to the plain version; N is at most ``MAX_BOXES``.
    ``greedy_keep_cuda.launches`` counts the launches."""
    if boxes_sorted.device.type == "cpu":
        return greedy_keep_plain(boxes_sorted, valid_sorted, iou_thres)
    if boxes_sorted.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes_sorted.device}")
    lead, n = tuple(valid_sorted.shape[:-1]), valid_sorted.shape[-1]
    if (boxes_sorted.shape != (*lead, n, 4)
            or boxes_sorted.dtype != torch.float32
            or valid_sorted.dtype != torch.bool
            or valid_sorted.device != boxes_sorted.device):
        raise ValueError("boxes must be float32 [..., N, 4] and valid bool "
                         "[..., N] on one device")
    if n > MAX_BOXES:
        raise ValueError(f"kernel N1 takes at most {MAX_BOXES} boxes a "
                         f"group, not {n}")
    groups = math.prod(lead)
    boxes = boxes_sorted.reshape(groups, n, 4).contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()     # the kernel reads a box as one float4
    valid = valid_sorted.reshape(groups, n).contiguous()
    keep = torch.empty((groups, n), dtype=torch.bool, device=boxes.device)
    if groups * n:
        fn = _lib().nms_keep
        ctx, stream = _launch_env(boxes.device)
        with ctx:
            err = fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                     groups, n, float(iou_thres), stream)
        if err != 0:
            raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
        greedy_keep_cuda.launches += 1
    return keep.reshape(*lead, n)


greedy_keep_cuda.launches = 0


@torch.library.custom_op("odt::greedy_keep", mutates_args=())
def _greedy_keep(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                 iou_thres: float) -> torch.Tensor:
    """The greedy keep mask as one opaque op (module note)."""
    return greedy_keep_cuda(boxes_sorted, valid_sorted, iou_thres)


@_greedy_keep.register_fake
def _(boxes_sorted, valid_sorted, iou_thres):
    return torch.empty_like(valid_sorted)


def nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
        iou_thres: float, valid: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over boxes [..., N, 4], scores [..., N].

    Returns (indices [..., max_out] int64 into the input order, padded with
    -1; valid_out [..., max_out] bool). Selected boxes appear in descending
    score order (tf.image.non_max_suppression order)."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    order = torch.sort(masked, dim=-1, descending=True, stable=True)[1]
    boxes_s = torch.gather(
        boxes, -2, order[..., None].expand(*order.shape, 4))
    valid_s = torch.gather(valid, -1, order)

    keep = _greedy_keep(boxes_s, valid_s, float(iou_thres))

    rank = torch.cumsum(keep.long(), dim=-1) - 1
    sel = keep & (rank < max_out)
    # unselected entries write into a spare column max_out, dropped below
    write_pos = torch.where(sel, rank, torch.full_like(rank, max_out))
    out = torch.full(order.shape[:-1] + (max_out + 1,), -1,
                     dtype=torch.long, device=order.device)
    out.scatter_(-1, write_pos, order)
    out_idx = out[..., :max_out]
    return out_idx, out_idx >= 0
