"""EfficientDet: the inference forward (backbone -> BiFPN -> heads ->
postprocess -> level-indexed ROIAlign), the training losses and the
precise-BN calibration (port of
object_detection_tracking_tpu/models/efficientdet/efficientdet.py:27-487).

The same output contract as FasterRCNNFPN (without ``fpn_box_feat``):
sigmoid class scores, a global top-k over all anchors, decode, per-class
exact NMS, the top ``result_per_im``, and each detection's tracking
feature pooled by ROIAlign from the BiFPN level whose anchor produced it.

The batch dimension is written out (JAX vmaps its per-image postprocess):
every top-k is a stable descending sort (``sort_desc_stable``), so ties
go to the lower index as in ``jax.lax.top_k``, and the per-class NMS is
one call of the batched ``nms`` over [B, classes, kc], not one per class.
Invalid detections keep JAX's zero box and level 0 and go through the
ROIAlign like the others (their samples fall off the map and pool to 0).

``config.roi_align_impl`` keeps the JAX gate: "pallas" runs kernel B1's
wrapper with the per-ROI levels (ops/roi_align.py
multilevel_roi_align_cuda: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors), "xla" the plain exact version. The Pallas kernel
loses samples of elongated boxes outside its 40x48 window when the levels
are explicit (roi_align_pallas.py:475-495); both port versions keep the
exact semantics (ROADMAP C2).

Training (``forward_train``) runs the trunk with batch-statistics BN
(``batch_bn``), labels the anchors with ``effdet_anchor_targets`` and
takes automl's losses; it runs no ROIAlign. After training,
``calibrate_bn`` writes each BN site's averaged batch statistics into its
stored mean and variance, which inference then applies.

Module names follow the JAX param tree (``backbone``, ``resample.p6``,
``fpn_cells.cell_{r}.fnode{n}`` with its ``dw``/``pw``/``bn``, the
fast-attention ``wsm`` vector and the cell-0 ``resample_{i}_{o}_{m}``
channel convs, ``class_net``/``box_net`` with ``conv{i}``,
``bn{i}_l{L}`` and ``predict``). Activations NCHW (channels_last memory
on the card); the ROIAlign reads the levels as NHWC views.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ...class_ids import coco_obj_class_to_id
from ...ops.boxes import clip_boxes
from ...ops.nms import nms, sort_desc_stable
from ...ops.norm import FrozenBN, batch_bn, batch_stats, frozen_bn
from ...ops.roi_align import multilevel_roi_align, multilevel_roi_align_cuda
from ...parallel.mesh import data_sum
from ...train.losses import focal_loss, huber
from ...train.targets import effdet_anchor_targets
from ..faster_rcnn import FasterRCNNFPN, _gather_rows
from ..layers import Conv, conv2d, max_pool, upsample2x_nearest
from .anchors import decode_effdet_boxes, effdet_anchors
from .efficientnet import EfficientNet, scaled_block_args, swish

# name -> (backbone, image_size, fpn_filters, fpn_repeats, head_repeats,
#          fusion, anchor_scale); d6/d7 use unweighted-sum BiFPN fusion and
# d7 widens the anchors to 5.0 (automl hparams)
EFFICIENTDET_CONFIGS = {
    "efficientdet-d0": ("efficientnet-b0", 512, 64, 3, 3, "fastattn", 4.0),
    "efficientdet-d1": ("efficientnet-b1", 640, 88, 4, 3, "fastattn", 4.0),
    "efficientdet-d2": ("efficientnet-b2", 768, 112, 5, 3, "fastattn", 4.0),
    "efficientdet-d3": ("efficientnet-b3", 896, 160, 6, 4, "fastattn", 4.0),
    "efficientdet-d4": ("efficientnet-b4", 1024, 224, 7, 4, "fastattn", 4.0),
    "efficientdet-d5": ("efficientnet-b5", 1280, 288, 7, 4, "fastattn", 4.0),
    "efficientdet-d6": ("efficientnet-b6", 1280, 384, 8, 5, "sum", 4.0),
    "efficientdet-d7": ("efficientnet-b6", 1536, 384, 8, 5, "sum", 5.0),
    # tiny variant for CPU unit tests only (not a reference model)
    "efficientdet-test": ("efficientnet-b0", 128, 32, 2, 2, "fastattn", 4.0),
}

# BiFPN graph for levels 3..7: (output level, input node ids); ids 0..4 are
# P3..P7 as the cell receives them, then one new id per fnode
BIFPN_NODES = [
    (6, (3, 4)),
    (5, (2, 5)),
    (4, (1, 6)),
    (3, (0, 7)),
    (4, (1, 7, 8)),
    (5, (2, 6, 9)),
    (6, (3, 5, 10)),
    (7, (4, 11)),
]
MIN_LEVEL, MAX_LEVEL = 3, 7
NUM_ANCHORS = 9
STRIDES = tuple(2 ** lvl for lvl in range(MIN_LEVEL, MAX_LEVEL + 1))
_NEG = -1e30
_DOWN_PAD = ((1, 0), (1, 0))   # the 3x3/2 max pool's TF-SAME padding


def backbone_channels(backbone_name: str):
    """C3, C4, C5 channels of an EfficientNet."""
    args = scaled_block_args(backbone_name)
    return args[2][4], args[4][4], args[6][4]


class SepConv(nn.Module):
    """Separable conv: depthwise ``dw`` (no bias), pointwise ``pw``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 bias: bool = True):
        super().__init__()
        self.dw = Conv(kernel, cin, cin, use_bias=False, groups=cin)
        self.pw = Conv(1, cin, cout, use_bias=bias)


def _sep_conv(p: SepConv, x: torch.Tensor) -> torch.Tensor:
    pad = p.dw.weight.shape[-1] // 2
    x = conv2d(p.dw, x, padding=((pad, pad), (pad, pad)))
    return conv2d(p.pw, x)


class FNode(SepConv):
    """One BiFPN node: its separable conv and ``bn``, with fast-attention
    fusion the per-input weights ``wsm``, and in cell 0 a 1x1 conv + BN
    ``resample_{idx}_{off}_{node id}`` for each input taken from the raw
    backbone (its own, as in the automl graph: a level consumed by two
    nodes has two)."""

    def __init__(self, c: int, ni: int, inputs, fastattn: bool,
                 raw_ch: Dict[int, int]):
        super().__init__(c, c)
        self.bn = FrozenBN(c)
        if fastattn:
            self.wsm = nn.Parameter(torch.ones(len(inputs)),
                                    requires_grad=False)
        for idx, off in enumerate(inputs):
            if off in raw_ch:
                self.add_module(f"resample_{idx}_{off}_{5 + ni}",
                                Conv(1, raw_ch[off], c, bn=True))


class Head(nn.Module):
    """Class or box net: separable convs ``conv{i}`` shared across levels,
    BN ``bn{i}_l{L}`` per level, and ``predict``."""

    def __init__(self, c: int, repeats: int, out_ch: int):
        super().__init__()
        self.repeats = repeats
        for i in range(repeats):
            self.add_module(f"conv{i}", SepConv(c, c))
            for lvl in range(MIN_LEVEL, MAX_LEVEL + 1):
                self.add_module(f"bn{i}_l{lvl}", FrozenBN(c))
        self.predict = SepConv(c, out_ch)

    def forward(self, x: torch.Tensor, lvl: int, bn=frozen_bn
                ) -> torch.Tensor:
        for i in range(self.repeats):
            orig = x
            x = _sep_conv(getattr(self, f"conv{i}"), x)
            x = swish(bn(getattr(self, f"bn{i}_l{lvl}"), x))
            if i > 0:
                x = x + orig
        return _sep_conv(self.predict, x)


class EfficientDet(nn.Module):
    """Same interface as FasterRCNNFPN: ``forward(images)`` -> dict of [B,
    ...] outputs; load weights with params.params_from_jax. Sigmoid heads
    over ``config.num_class - 1`` classes (the COCO 90-id map is the
    caller's); with ``config.partial_classes``, only those classes' score
    columns enter the postprocess, and labels number them from 1."""

    def __init__(self, config, model_name: str = None):
        super().__init__()
        cfg = config
        self.config = cfg
        name = model_name or getattr(cfg, "efficientdet_name",
                                     "efficientdet-d0")
        (self.backbone_name, self.image_size, self.fpn_filters,
         self.fpn_repeats, self.head_repeats, self.fusion,
         self.anchor_scale) = EFFICIENTDET_CONFIGS[name]
        if getattr(cfg, "efficientdet_image_size", 0):
            self.image_size = cfg.efficientdet_image_size
        if cfg.roi_align_impl not in ("pallas", "xla"):
            raise ValueError(f"unknown roi_align_impl {cfg.roi_align_impl!r}")
        self.name = name
        self.num_classes = cfg.num_class - 1   # sigmoid heads, no BG row
        if cfg.partial_classes:
            self.register_buffer("partial_score_idx", torch.tensor(
                [coco_obj_class_to_id[n] - 1 for n in cfg.partial_classes]),
                persistent=False)
        else:
            self.partial_score_idx = None
        self.compute_dtype = getattr(torch, cfg.compute_dtype)

        c = self.fpn_filters
        self.backbone = EfficientNet(self.backbone_name)
        c3, c4, c5 = backbone_channels(self.backbone_name)
        raw_ch = {0: c3, 1: c4, 2: c5}   # input node id -> raw channels
        # P6: 1x1 C5 -> C + BN + max pool; P7 a further max pool
        self.resample = nn.ModuleDict({"p6": Conv(1, c5, c, bn=True)})
        self.fpn_cells = nn.ModuleDict({
            f"cell_{rep}": nn.ModuleDict({
                f"fnode{ni}": FNode(c, ni, inputs, self.fusion == "fastattn",
                                    raw_ch if rep == 0 else {})
                for ni, (_lvl, inputs) in enumerate(BIFPN_NODES)})
            for rep in range(self.fpn_repeats)})
        self.class_net = Head(c, self.head_repeats,
                              self.num_classes * NUM_ANCHORS)
        self.box_net = Head(c, self.head_repeats, 4 * NUM_ANCHORS)
        self._anchors: Dict = {}
        self.requires_grad_(bool(cfg.is_train))

    @property
    def device(self) -> torch.device:
        return self.class_net.predict.pw.weight.device

    # ------------------------------------------------------------------

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """[B, h, w, 3] BGR (or [B, 3h/2, w] I420) -> padded normalized RGB
        [B, S, S, 3] in the compute dtype."""
        if images.dim() == 3:
            images = FasterRCNNFPN.i420_to_bgr(images)
        x = images.float().flip(-1)                 # BGR -> RGB
        # an IEEE division on every device (CUDA turns division by a
        # Python scalar into a multiplication by its reciprocal)
        x = x / torch.tensor(255.0, device=x.device)
        mean = torch.tensor([0.485, 0.456, 0.406], device=x.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=x.device)
        x = (x - mean) / std
        s = self.image_size
        h, w = x.shape[1:3]
        x = nn.functional.pad(x, (0, 0, 0, s - w, 0, s - h))
        return x.to(self.compute_dtype)

    def _bifpn_cell(self, cell: nn.ModuleDict, feats: List[torch.Tensor],
                    bn=frozen_bn) -> List[torch.Tensor]:
        """feats: P3..P7 (ids 0..4) -> new P3..P7. In cell 0, inputs from
        the raw backbone first go through their node's 1x1 conv + BN (the
        conv before the spatial resample, as automl's
        resample_feature_map)."""
        nodes = list(feats)
        sizes = [f.shape[2] for f in feats]
        for ni, (lvl, inputs) in enumerate(BIFPN_NODES):
            p = cell[f"fnode{ni}"]
            target = sizes[lvl - MIN_LEVEL]
            resampled = []
            for idx, off in enumerate(inputs):
                n = nodes[off]
                rp = getattr(p, f"resample_{idx}_{off}_{5 + ni}", None)
                if rp is not None:
                    n = bn(rp.bn, conv2d(rp, n))
                if n.shape[2] > target:       # downsample by 2
                    n = max_pool(n, 3, 2, padding=_DOWN_PAD)
                elif n.shape[2] < target:     # upsample by 2
                    n = upsample2x_nearest(n)
                resampled.append(n)
            if hasattr(p, "wsm"):             # fast-attention fusion
                w = torch.relu(p.wsm)
                w = w / (w.sum() + 1e-4)
                fused = sum(r * w[i].to(r.dtype)
                            for i, r in enumerate(resampled))
            else:                             # unweighted sum (d6/d7)
                fused = sum(resampled)
            out = _sep_conv(p, swish(fused))
            nodes.append(bn(p.bn, out))
        # output node ids: P3''=8, P4''=9, P5''=10, P6''=11, P7''=12
        return nodes[8:13]

    def features(self, images: torch.Tensor, bn=frozen_bn
                 ) -> List[torch.Tensor]:
        """Preprocess -> backbone -> P6/P7 resample -> BiFPN: P3..P7,
        NCHW."""
        x = self.preprocess(images).permute(0, 3, 1, 2)
        c3, c4, c5 = self.backbone(x, bn=bn)
        p6 = bn(self.resample["p6"].bn, conv2d(self.resample["p6"], c5))
        p6 = max_pool(p6, 3, 2, padding=_DOWN_PAD)
        p7 = max_pool(p6, 3, 2, padding=_DOWN_PAD)
        feats = [c3, c4, c5, p6, p7]
        for rep in range(self.fpn_repeats):
            feats = self._bifpn_cell(self.fpn_cells[f"cell_{rep}"], feats,
                                     bn=bn)
        return feats

    def heads(self, feats: List[torch.Tensor], bn=frozen_bn):
        """Class and box logits per level, NCHW in the compute dtype."""
        cls_outs = [self.class_net(f, MIN_LEVEL + li, bn=bn)
                    for li, f in enumerate(feats)]
        box_outs = [self.box_net(f, MIN_LEVEL + li, bn=bn)
                    for li, f in enumerate(feats)]
        return cls_outs, box_outs

    def _anchor_set(self):
        """The flat anchors [N, 4] and each anchor's level index [N]
        (int32, 0 for P3), built once per device."""
        key = self.device
        if key not in self._anchors:
            anchors = effdet_anchors((self.image_size, self.image_size),
                                     anchor_scale=self.anchor_scale)
            flat = np.concatenate([a.reshape(-1, 4) for a in anchors])
            levels = np.concatenate([np.full(a.size // 4, li, np.int32)
                                     for li, a in enumerate(anchors)])
            self._anchors[key] = (torch.from_numpy(flat).to(key),
                                  torch.from_numpy(levels).to(key))
        return self._anchors[key]

    def flat_heads(self, cls_outs, box_outs):
        """Per-anchor float32 logits over all levels: cls [B, N, classes],
        box [B, N, 4], anchors in the order of ``effdet_anchors`` (level,
        row, column, anchor)."""
        b = cls_outs[0].shape[0]
        cls_flat = torch.cat(
            [c.permute(0, 2, 3, 1).reshape(b, -1, self.num_classes).float()
             for c in cls_outs], dim=1)
        box_flat = torch.cat(
            [o.permute(0, 2, 3, 1).reshape(b, -1, 4).float()
             for o in box_outs], dim=1)
        return cls_flat, box_flat

    def postprocess(self, cls_flat, box_flat, hw):
        """Batched JAX ``_postprocess_single``: sigmoid scores, the global
        top-k, decode and clip, the per-class top-kc and exact NMS, the
        top R. Returns final (boxes [B, R, 4], labels [B, R] int32, probs
        [B, R], valid [B, R], source levels [B, R] int32)."""
        cfg = self.config
        r = cfg.result_per_im
        anchors_flat, anchor_levels = self._anchor_set()
        b = cls_flat.shape[0]
        scores_all = torch.sigmoid(cls_flat)                  # [B, N, C]
        if self.partial_score_idx is not None:
            scores_all = scores_all[:, :, self.partial_score_idx]
        best = scores_all.amax(dim=2)
        k = min(cfg.efficientdet_max_detection_topk, best.shape[1])
        _, top_i = sort_desc_stable(best, k)                  # [B, k]
        scores = _gather_rows(scores_all, top_i)              # [B, k, C]
        levels = anchor_levels[top_i]                         # [B, k]
        boxes = decode_effdet_boxes(_gather_rows(box_flat, top_i),
                                    anchors_flat[top_i])
        boxes = clip_boxes(boxes, hw)

        # per-class top-kc preselect keeps the NMS matrices small
        kc = min(2 * r, k)
        cls_scores, cls_idx = sort_desc_stable(scores.transpose(1, 2), kc)
        img = torch.arange(b, device=cls_idx.device)[:, None, None]
        cls_boxes = boxes[img, cls_idx]                       # [B, C, kc, 4]
        cls_lvls = levels[img, cls_idx]                       # [B, C, kc]
        valid = cls_scores > cfg.result_score_thres
        idx, val = nms(cls_boxes, cls_scores, r, cfg.fastrcnn_nms_iou_thres,
                       valid=valid)                           # [B, C, r]
        idx_c = idx.clamp_min(0)
        cb = torch.where(val[..., None], _gather_rows(cls_boxes, idx_c), 0.0)
        cp = torch.where(val, torch.gather(cls_scores, -1, idx_c), _NEG)
        cl = torch.where(val, torch.gather(cls_lvls, -1, idx_c), 0)

        flat_p = cp.reshape(b, -1)
        flat_v = val.reshape(b, -1)
        top_p, top_idx = sort_desc_stable(
            torch.where(flat_v, flat_p, _NEG), r)
        final_valid = torch.gather(flat_v, 1, top_idx)
        final_boxes = torch.where(final_valid[..., None], _gather_rows(
            cb.reshape(b, -1, 4), top_idx), 0.0)
        final_labels = torch.where(final_valid, top_idx // r + 1, 0).to(
            torch.int32)
        final_probs = torch.where(final_valid, top_p, 0.0)
        final_levels = torch.where(
            final_valid, torch.gather(cl.reshape(b, -1), 1, top_idx), 0).to(
                torch.int32)
        return final_boxes, final_labels, final_probs, final_valid, \
            final_levels

    def roi_features(self, feats: List[torch.Tensor], boxes: torch.Tensor,
                     levels: torch.Tensor) -> torch.Tensor:
        """[B, R, 7, 7, C] float32: each box pooled from its own level of
        the BiFPN pyramid (strides 8..128)."""
        nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in feats]
        fn = (multilevel_roi_align_cuda if self.config.roi_align_impl
              == "pallas" else multilevel_roi_align)
        return fn(nhwc, boxes.contiguous(), STRIDES, 7, levels=levels)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Batched inference. images: [B, h, w, 3] BGR (uint8 or float,
        0-255) or [B, 3h/2, w] planar I420 uint8, h, w <= image_size, on
        the model's device."""
        if images.dim() == 3:
            h, w = images.shape[1] * 2 // 3, images.shape[2]
        else:
            h, w = images.shape[1:3]
        feats = self.features(images)
        cls_flat, box_flat = self.flat_heads(*self.heads(feats))
        fb, fl, fp, fv, flv = self.postprocess(cls_flat, box_flat, (h, w))
        box_feat = self.roi_features(feats, fb, flv)
        return {
            "final_boxes": fb,
            "final_labels": fl,
            "final_probs": fp,
            "final_valid": fv,
            "pooled_box_feat": box_feat.mean(dim=(2, 3)),
        }

    # ------------------------------------------------------------------

    def forward_train(self, images, gt_boxes, gt_labels, gt_valid,
                      gt_masks=None, generator=None, noise=None,
                      sync_group=None) -> Dict[str, torch.Tensor]:
        """Training losses (JAX efficientdet.py:382-425): automl's recipe,
        focal loss (alpha 0.25, gamma 1.5) over sigmoid class logits and
        huber (delta 0.1) over the fg anchors' box deltas, weighted 50,
        with the trunk in batch-statistics BN. ``FasterRCNNFPN``'s
        signature, so ``Trainer`` drives either model; the anchor labeling
        draws nothing, so ``gt_masks``, ``generator`` and ``noise`` are
        ignored. images [B, h, w, 3] BGR, gt_* [B, G, ...] padded with
        ``gt_valid``. ``sync_group``: the process group of a data-parallel
        step's ranks (parallel/mesh.py), over which the BN statistics and
        the positive count are the whole batch's, as JAX's are under
        pjit."""
        b = images.shape[0]
        bn = functools.partial(batch_bn, group=sync_group)
        feats = self.features(images, bn=bn)
        cls_flat, box_flat = self.flat_heads(*self.heads(feats, bn=bn))
        anchors, _ = self._anchor_set()
        cls_t, box_t, fg = effdet_anchor_targets(anchors, gt_boxes,
                                                 gt_labels, gt_valid)
        # one-hot without a background column: label 0 (background) gives
        # the all-zero row, as JAX's one_hot(label - 1) does
        classes = torch.arange(1, self.num_classes + 1, device=cls_t.device)
        onehot = (cls_t[..., None] == classes).float()       # [B, N, C]
        # JAX counts the positives of the whole batch: in a data-parallel
        # step each rank divides by its share of the global count, so the
        # ranks' mean loss is the global batch's
        num_pos, n_ranks = data_sum(fg.sum().float(), sync_group)
        num_pos = num_pos.clamp_min(1.0) / n_ranks
        cls_loss = focal_loss(cls_flat, onehot, alpha=0.25,
                              gamma=1.5).sum() / num_pos
        box_err = huber(box_flat - box_t, delta=0.1)
        box_loss = torch.where(fg[..., None], box_err,
                               torch.zeros_like(box_err)).sum() \
            / (num_pos * 4.0)
        return {
            "total_loss": cls_loss + 50.0 * box_loss,
            "effdet_cls_loss": cls_loss,
            "effdet_box_loss": box_loss,
            "num_pos_anchors": num_pos / b,
        }

    @torch.no_grad()
    def calibrate_bn(self, image_batches, max_batches: int = 16
                     ) -> "EfficientDet":
        """Precise-BN recalibration (JAX efficientdet.py:427-487): run up
        to ``max_batches`` image batches (uint8 [B, h, w, 3], numpy or
        torch) through the trunk and heads with batch-statistics BN,
        average each BN site's batch mean and variance (``batch_stats``,
        summed in float64 on the host) and write them as float32 into its
        ``FrozenBN``'s ``mean`` and ``variance``, which inference applies.
        The ``FrozenBN`` module is the site's key, so one pass finds the
        sites. Returns the model."""
        sums: Dict[FrozenBN, list] = {}
        n = 0
        for images in image_batches:
            sites, stats = [], []

            def bn(p, x):
                mu, var = batch_stats(x)
                sites.append(p)
                stats.extend((mu, var))
                return batch_bn(p, x)

            if not isinstance(images, torch.Tensor):
                images = torch.from_numpy(np.ascontiguousarray(images))
            self.heads(self.features(images.to(self.device), bn=bn), bn=bn)
            flat = torch.cat(stats).double().cpu()   # one copy to the host
            off = 0
            for p in sites:
                c = p.mean.numel()
                acc = sums.setdefault(p, [0.0, 0.0])
                acc[0] = acc[0] + flat[off:off + c]
                acc[1] = acc[1] + flat[off + c:off + 2 * c]
                off += 2 * c
            n += 1
            if n == max_batches:
                break
        for p, (sum_mu, sum_var) in sums.items():
            p.mean.copy_((sum_mu / n).float())
            p.variance.copy_((sum_var / n).float())
        print(f"calibrated {len(sums)} BN sites over {n} batches")
        return self
