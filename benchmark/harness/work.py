"""The yardstick's arithmetic, frozen with the benchmark: the card's peaks,
the least time of a ROIAlign launch (kernel B1) and of a greedy-NMS launch
(kernel N1) on their own inputs, and the model FLOPs of a forward counted
on the ``meta`` device over the reference's conv, deconv and linear
layers.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 989e12 bf16 FLOP/s,
67e12 float32 FLOP/s outside the tensor cores, 3.35e12 bytes/s of HBM.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..reference import detector as ref

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations of one (kept box, later valid box) IOU test, and of
# one box's own area and validity
NMS_PAIR_OPS, NMS_BOX_OPS = 13, 3


# ---------------------------------------------------------------------------
# ROIAlign (B1)


def roi_touched_bytes(feat_shapes: Sequence[Tuple[int, ...]], elem_bytes: int,
                      boxes: torch.Tensor, valid: torch.Tensor,
                      strides: Sequence[int], pool: int) -> int:
    """Bytes of the feature pixels that the valid boxes' bilinear taps read
    on their canonical levels, counted once per image and level: a box
    reads the two neighbour rows of each in-map y-sample crossed with the
    two neighbour columns of each in-map x-sample; the union over an
    image's boxes is one product of those row and column sets.
    ``feat_shapes`` are the levels' NHWC shapes."""
    b, n = boxes.shape[:2]
    dev = boxes.device
    lvl = ref.roi_levels(boxes).clamp(0, len(feat_shapes) - 1)
    stride = torch.tensor([float(s) for s in strides], device=dev)
    fb = boxes / stride[lvl][..., None]
    s2 = 2 * pool
    grid = torch.arange(s2, dtype=torch.float32, device=dev) + 0.5

    def samples(lo, hi):
        return lo[..., None] + ref.div(hi - lo, float(s2))[..., None] \
            * grid - 0.5

    def taps(s, extent, sel):
        inside = (s >= 0) & (s <= extent - 1) & sel[..., None]
        lo = torch.floor(s).long().clamp(0, extent - 1)
        hi = (lo + 1).clamp(max=extent - 1)
        m = torch.zeros(b, n, extent + 1, device=dev)
        for idx in (lo, hi):
            m.scatter_(-1, torch.where(inside, idx, extent), 1.0)
        return m[..., :extent]

    ys, xs = samples(fb[..., 1], fb[..., 3]), samples(fb[..., 0], fb[..., 2])
    touched = 0
    for li, shape in enumerate(feat_shapes):
        h, w, c = shape[1], shape[2], shape[3]
        sel = valid & (lvl == li)
        cover = torch.einsum("bny,bnx->byx", taps(ys, h, sel),
                             taps(xs, w, sel)) > 0
        touched += int(cover.sum().item()) * c * elem_bytes
    return touched


def roi_bound_s(feat_shapes, elem_bytes, boxes, valid, strides, pool
                ) -> float:
    """The least time of one B1 launch: the pixels its valid boxes' taps
    touch (``roi_touched_bytes``), its float32 output, and 17 bytes a ROI
    (box, validity) over the memory rate; its few operations a byte leave
    it bound by bytes."""
    b, n = boxes.shape[:2]
    c = feat_shapes[0][-1]
    nbytes = (roi_touched_bytes(feat_shapes, elem_bytes, boxes, valid,
                                strides, pool)
              + b * n * pool * pool * c * 4 + b * n * 17)
    return nbytes / PEAK_BYTES


# ---------------------------------------------------------------------------
# greedy NMS (N1)


def nms_bound_s(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                thres: float) -> float:
    """The least time of one N1 launch on its inputs (score-sorted boxes
    [..., N, 4], validity [..., N]): the boxes and validity read once and
    the keep mask written once over the memory rate, against
    ``NMS_PAIR_OPS`` float32 operations for each (kept box, later valid
    box) pair, the tests greedy NMS needs on this data, and
    ``NMS_BOX_OPS`` a box, over the float32 rate. The kept boxes come from
    the reference's own greedy NMS."""
    n = valid_sorted.shape[-1]
    keep = ref.greedy_keep(boxes_sorted.reshape(-1, n, 4).float(),
                           valid_sorted.reshape(-1, n), thres)
    valid = valid_sorted.reshape(-1, n)
    later = valid.flip(-1).long().cumsum(-1).flip(-1) - valid.long()
    pairs = int((keep.long() * later).sum().item())
    nbytes = boxes_sorted.numel() * 4 + 2 * valid.numel()
    ops = NMS_PAIR_OPS * pairs + NMS_BOX_OPS * valid.numel()
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS)


# ---------------------------------------------------------------------------
# model FLOPs


class FlopCount(TorchDispatchMode):
    """Counts 2 operations a multiply-add of every convolution (transposed
    too) and matrix product dispatched under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name == "convolution":
            x, w = args[0], args[1]
            transposed = args[6]
            if transposed:
                # weight [in, out/groups, k, k]: each input value meets
                # every tap of its group's outputs
                self.flops += 2 * x.numel() * math.prod(w.shape[1:])
            else:
                self.flops += 2 * out.numel() * math.prod(w.shape[1:])
        elif name in ("mm", "addmm"):
            a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
            self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        elif name == "bmm":
            a, b = args[0], args[1]
            self.flops += 2 * a.shape[0] * a.shape[1] * a.shape[2] \
                * b.shape[2]
        return out


def forward_flops(shapes: Dict[str, Tuple[int, ...]], model: dict,
                  batch: int, h: int, w: int, rois: int) -> Dict[str, int]:
    """Model FLOPs of one forward of ``batch`` images of h x w by the
    reference's dense layers, on the ``meta`` device: the backbone, FPN and
    RPN over the padded image, the box head over ``rois`` proposals an
    image, and with masks the mask head over ``result_per_im`` detections
    an image. ROIAlign, NMS and elementwise work are not counted."""
    tree = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    det = ref.ReferenceDetector(tree, model)
    mult = model["fpn_multiple"]
    hp, wp = -(-h // mult) * mult, -(-w // mult) * mult
    out = {}
    with FlopCount() as fc:
        x = torch.empty(batch, 3, hp, wp, device="meta")
        p = det.fpn(det.backbone(x))
        det.rpn({"p": p})
    out["backbone_fpn_rpn"] = fc.flops
    with FlopCount() as fc:
        x = torch.empty(batch * rois, 7 * 7 * model["fpn_channels"],
                        device="meta")
        x = det.linear("fastrcnn.fc7", det.linear("fastrcnn.fc6", x))
        det.linear("fastrcnn.outputs.class", x)
        det.linear("fastrcnn.outputs.box", x)
    out["box_head"] = fc.flops
    if model["mask"]:
        r = model["result_per_im"]
        with FlopCount() as fc:
            x = torch.empty(batch * r, model["fpn_channels"], 14, 14,
                            device="meta")
            for k in range(4):
                x = det.conv(f"maskrcnn.fcn{k}", x)
            wt = det.w("maskrcnn.deconv.weight")
            x = torch.nn.functional.conv_transpose2d(
                x, wt.flip(2, 3).transpose(0, 1), stride=2)
            det.conv("maskrcnn.conv", x)
        out["mask_head"] = fc.flops
    out["total"] = sum(out.values())
    return out
