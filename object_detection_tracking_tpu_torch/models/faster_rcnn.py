"""Faster-RCNN-FPN detector, the inference forward and the training losses
(port of object_detection_tracking_tpu/models/faster_rcnn.py:54-821).

Shapes stay static and padded as in the JAX model: proposals and detections
are fixed-size arrays with validity masks, so the output contract is the
JAX one. The batch dimension is written out (the JAX model vmaps its
per-image tail). Sort-sensitive stages use a stable descending sort, so
ties resolve to the lower index as ``jax.lax.top_k`` does; NMS is the exact
greedy op of ops/nms.py; the RPN top-k is always exact (the JAX config's
``rpn_topk_recall`` < 1 selects a TPU-only approximate top-k, which the port
does not have).

``config.backbone_impl`` keeps the JAX gate too: "pallas" runs the
stride-1 bottleneck tails through the bottleneck-stage kernel's wrapper
(models/resnet.py), "xla" the unfused blocks.

``config.roi_align_impl`` keeps the JAX gate: "pallas" runs the
hand-written kernel's wrapper (ops/roi_align.py multilevel_roi_align_cuda:
the CUDA kernel for CUDA tensors, the plain version for CPU tensors), "xla"
runs the plain exact version on any device. In training (``is_train``)
"pallas" is replaced by ``config.roi_align_train_impl`` as in JAX
(faster_rcnn.py:462-482): "pallas" runs ``multilevel_roi_align_trainable``
(kernels B1 and B1b on CUDA tensors), "xla" autograd of the plain version.

``forward_train`` returns the training losses (JAX faster_rcnn.py:679-821):
RPN losses over all anchors, proposals at the train top-k on detached
logits, sampled RoI targets, the box head's losses and, with ``add_mask``
and gt masks, the mask loss. Each loss is reduced per image, then averaged
over the batch, as JAX's ``vmap`` and ``.mean()`` do. The random subsamples
take uniform draws from a ``torch.Generator`` or, given ``noise``, those
draws (train/targets.py).

The architecture options of the inference CLIs are the JAX ones:
``use_gn`` (FPN GroupNorm), ``use_deformable`` (deformable conv2 in the
last blocks of c3-c5, whose groups then run unfused),
``use_conv_frcnn_head``, ``use_att_frcnn_head`` and ``add_relation_nn``
(models/heads.py). The relation residuals see each image's proposals with
their validity, so padded slots stay out of the attention (ROADMAP C14).

The small-object heads (``use_small_object_head``, JAX faster_rcnn.py:
354-446, :823-866; reference models.py:592-691): per small-object (SO)
class, the box head's decoded boxes are cut to R = ``result_per_im`` by
NMS, pooled again (7x7, with the person references of
``use_so_association`` in the same ROIAlign launch) through the shared
fc6/fc7 in float32 whatever the compute dtype (JAX casts the features to
float32 there), optionally attend to the ``so_person_topk`` person boxes
(``person_object_relation``), and a per-class 2-way dense scores them.
Inference returns ``so_final_*`` beside the main detections; training adds
``so_label_loss``, whose gradient reaches the box head through the pooled
boxes (ROIAlign's box gradient: kernel B1e on CUDA tensors) and through the
relation's geometry. Padded slots (NMS dropouts, zero boxes) stay out of
the relation's attention as in C14 (ROADMAP C18).

``extract_box_feat`` is the feature extractor alone: the backbone and one
ROIAlign on the caller's boxes, mean-pooled.

Outputs per image (R = config.result_per_im): final_boxes [R, 4] x1y1x2y2,
final_labels [R] int32, final_probs [R], final_valid [R] bool,
pooled_box_feat [R, 256] and fpn_box_feat [R, 7, 7, 256]; with
``config.add_mask``, final_masks [R, 28, 28] (sigmoid of the detection's
class mask from the Mask R-CNN head over a 14x14 ROIAlign).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..class_ids import coco_obj_class_to_id
from ..ops import anchors as anchor_lib
from ..ops.boxes import clip_boxes, decode_boxes, encode_boxes, pairwise_iou
from ..ops.nms import nms, sort_desc_stable
from ..ops.roi_align import (multilevel_roi_align, multilevel_roi_align_cuda,
                             multilevel_roi_align_trainable)
from ..train import losses as loss_lib
from ..train import targets as target_lib
from .fpn import FPN, RPNHead
from .heads import FastRCNN2FCHead, MaskRCNNUp4ConvHead
from .layers import dense
from .relation import Relation, person_object_relation
from .resnet import ResNet

# ImageNet BGR mean/std (the host feeds cv2 BGR frames; models.py:340-352)
_BGR_MEAN = np.array([0.406, 0.456, 0.485], np.float32)
_BGR_STD = np.array([0.225, 0.224, 0.229], np.float32)
_NEG = -1e30


def _round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., N, D] gathered along N by idx [..., K] -> [..., K, D]."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


class FasterRCNNFPN(nn.Module):
    """Module tree ``resnet``/``fpn``/``rpn``/``fastrcnn`` named as the JAX
    param tree; load weights with params.params_from_jax."""

    def __init__(self, config, keep_full_box_feat: bool = True):
        super().__init__()
        cfg = config
        self.config = cfg
        self.keep_full_box_feat = keep_full_box_feat
        if cfg.use_small_object_head and cfg.use_conv_frcnn_head:
            raise ValueError("the small-object heads reuse fc6/fc7, which "
                             "the conv box head does not have")
        if cfg.roi_align_impl not in ("pallas", "xla"):
            raise ValueError(f"unknown roi_align_impl {cfg.roi_align_impl!r}")
        if cfg.backbone_impl not in ("pallas", "xla"):
            raise ValueError(f"unknown backbone_impl {cfg.backbone_impl!r}")
        self.c_channels = ((64, 128, 256, 512) if cfg.use_basic_block
                           else (256, 512, 1024, 2048))
        self.resnet = ResNet(
            cfg.resnet_num_block, cfg.use_basic_block,
            use_dilations=cfg.use_dilations, use_se=cfg.use_se,
            use_resnext=cfg.use_resnext, use_deformable=cfg.use_deformable,
            fused_stages=cfg.backbone_impl == "pallas" and not cfg.is_train)
        self.fpn = FPN(self.c_channels, cfg.fpn_num_channel,
                       use_gn=cfg.use_gn)
        self.rpn = RPNHead(cfg.fpn_num_channel, cfg.num_anchors_per_cell)
        self.fastrcnn = FastRCNN2FCHead(
            cfg.num_class, cfg.fpn_num_channel, 7, cfg.fpn_frcnn_fc_head_dim,
            cfg.use_frcnn_class_agnostic,
            add_relation_nn=cfg.add_relation_nn,
            use_att_head=cfg.use_att_frcnn_head,
            use_conv_head=cfg.use_conv_frcnn_head,
            conv_dim=cfg.conv_frcnn_head_dim)
        self.maskrcnn = (MaskRCNNUp4ConvHead(cfg.num_class,
                                             cfg.fpn_num_channel,
                                             cfg.mrcnn_head_dim)
                         if cfg.add_mask else None)
        self.so_ids = [cfg.classname2id[n] - 1 for n in cfg.small_objects
                       if n in cfg.classname2id]
        if cfg.use_small_object_head:   # JAX faster_rcnn.py:109-123
            fc = cfg.fpn_frcnn_fc_head_dim
            so = {f"small_object_classification_c{i + 1}": nn.Linear(fc, 2)
                  for i in range(len(self.so_ids))}
            if cfg.use_so_association:
                so["person_object_relation"] = Relation(fc)
            self.small_objects = nn.ModuleDict(so)
        else:
            self.small_objects = None
        # partial-class gather indices (models.py:805-829)
        if cfg.partial_classes:
            ids = [coco_obj_class_to_id[n] for n in cfg.partial_classes]
            self.register_buffer("partial_label_idx",
                                 torch.tensor([0] + ids), persistent=False)
            self.register_buffer("partial_box_idx",
                                 torch.tensor([i - 1 for i in ids]),
                                 persistent=False)
            self.num_out_class = len(ids) + 1
        else:
            self.partial_label_idx = self.partial_box_idx = None
            self.num_out_class = cfg.num_class
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        # the forward's constants live on the model's device, so a forward
        # copies nothing from the host: no sync, and a CUDA graph can
        # capture it
        for name, value in (("bgr_mean", _BGR_MEAN), ("bgr_std", _BGR_STD),
                            ("reg_w", cfg.fastrcnn_bbox_reg_weights)):
            self.register_buffer(
                name, torch.tensor(value, dtype=torch.float32),
                persistent=False)
        self.register_buffer("so_idx", torch.tensor(self.so_ids,
                                                    dtype=torch.long),
                             persistent=False)
        self._geometry: Dict = {}
        # every leaf takes gradients in training, as under jax.grad
        self.requires_grad_(bool(cfg.is_train))

    @property
    def device(self) -> torch.device:
        return self.fastrcnn.outputs["class"].weight.device

    # ------------------------------------------------------------------
    # static geometry

    def _static_geometry(self, h: int, w: int):
        """Anchor fields [n_l, 4] and pad-region validity masks [n_l] per
        level for an (h, w) image, built once per size and device
        (JAX faster_rcnn.py:129-153)."""
        key = (h, w, self.device)
        if key in self._geometry:
            return self._geometry[key]
        cfg = self.config
        hp = _round_up(h, cfg.fpn_resolution_requirement)
        wp = _round_up(w, cfg.fpn_resolution_requirement)
        fields, valids = [], []
        for li, stride in enumerate(cfg.anchor_strides):
            if li < 4:
                fh, fw = hp // stride, wp // stride
            else:  # p6 from stride-2 subsample of p5
                fh = -(-(hp // 32) // 2)
                fw = -(-(wp // 32) // 2)
            field = anchor_lib.get_all_anchors(
                stride, [cfg.anchor_sizes[li]], cfg.anchor_ratios, (fh, fw))
            vh = min(fh, -(-h // stride))
            vw = min(fw, -(-w // stride))
            valid = np.zeros((fh, fw, len(cfg.anchor_ratios)), bool)
            valid[:vh, :vw, :] = True
            fields.append(torch.from_numpy(field.reshape(-1, 4)).to(
                self.device))
            valids.append(torch.from_numpy(valid.reshape(-1)).to(self.device))
        self._geometry[key] = (hp, wp, fields, valids)
        return self._geometry[key]

    # ------------------------------------------------------------------
    # forward pieces

    @staticmethod
    def i420_to_bgr(images: torch.Tensor) -> torch.Tensor:
        """[B, 3h/2, w] planar YUV420 uint8 -> [B, h, w, 3] BGR float
        (0-255), cv2's BT.601 video range with nearest chroma upsampling
        and uint8 quantization (JAX faster_rcnn.py:158-183)."""
        b, h15, w = images.shape
        h = h15 * 2 // 3
        x = images.float()
        y = x[:, :h, :]
        u = x[:, h:h + h // 4, :].reshape(b, h // 2, w // 2)
        v = x[:, h + h // 4:, :].reshape(b, h // 2, w // 2)

        def up2(p):
            return p.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

        u = up2(u) - 128.0
        v = up2(v) - 128.0
        yy = 1.164 * (y - 16.0)
        bch = yy + 2.018 * u
        g = yy - 0.391 * u - 0.813 * v
        r = yy + 1.596 * v
        # torch.round, like jnp.round, rounds half to even
        return torch.round(torch.stack([bch, g, r], dim=-1).clamp(0.0, 255.0))

    def preprocess(self, images: torch.Tensor, hp: int, wp: int
                   ) -> torch.Tensor:
        """[B, h, w, 3] BGR uint8/float (or [B, 3h/2, w] planar I420) ->
        padded normalized [B, hp, wp, 3] in the compute dtype (JAX
        faster_rcnn.py:232-266, flat layout)."""
        if images.dim() == 3:
            images = self.i420_to_bgr(images)
        h, w = images.shape[1:3]
        x = images.float() * (1.0 / 255.0)
        x = (x - self.bgr_mean) / self.bgr_std
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        return x.to(self.compute_dtype)

    def backbone(self, p_images: torch.Tensor) -> List[torch.Tensor]:
        """NHWC padded images -> [p2..p6] NHWC views of channels_last maps
        (the views are contiguous NHWC, so ROIAlign reads them as is). In
        training, no gradient crosses group ``config.freeze``."""
        cfg = self.config
        c2345 = self.resnet(p_images.permute(0, 3, 1, 2),
                            freeze=cfg.freeze if cfg.is_train else -1)
        return [p.permute(0, 2, 3, 1) for p in self.fpn(c2345)]

    def _rpn_all_levels(self, p23456):
        outs = [self.rpn(p.permute(0, 3, 1, 2)) for p in p23456]
        return [o[0] for o in outs], [o[1] for o in outs]

    def _proposals(self, label_logits, box_logits, fields, valids,
                   h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched FPN proposals (JAX ``_proposals_single``,
        faster_rcnn.py:286-352): per-level exact top-k, decode + clip,
        per-level NMS, then the global top-k. label_logits [B, FH, FW, A]
        and box_logits [B, FH, FW, A, 4] per level. Returns (boxes [B, K, 4],
        valid [B, K]). The logits are detached, as JAX cuts gradients here
        (faster_rcnn.py:293-294)."""
        cfg = self.config
        kk = (cfg.rpn_train_post_nms_topk if cfg.is_train
              else cfg.rpn_test_post_nms_topk)
        label_logits = [x.detach() for x in label_logits]
        box_logits = [x.detach() for x in box_logits]
        b = label_logits[0].shape[0]
        lvl_boxes, lvl_scores, lvl_valid = [], [], []
        for lvl in range(cfg.num_levels):
            field, vmask = fields[lvl], valids[lvl]
            scores = label_logits[lvl].reshape(b, -1).float()
            deltas = box_logits[lvl].reshape(b, -1, 4).float()
            k_l = min(kk, scores.shape[1])
            masked = torch.where(vmask, scores, torch.full_like(scores, _NEG))
            top_scores, top_idx = sort_desc_stable(masked, k_l)
            top_boxes = decode_boxes(_gather_rows(deltas, top_idx),
                                     field[top_idx], cfg.bbox_decode_clip)
            top_boxes = clip_boxes(top_boxes, (h, w))
            wb = top_boxes[..., 2] - top_boxes[..., 0]
            hb = top_boxes[..., 3] - top_boxes[..., 1]
            top_valid = (vmask[top_idx] & (wb > cfg.rpn_min_size)
                         & (hb > cfg.rpn_min_size))
            if k_l < kk:  # tiny pyramid tops: pad to a common K
                top_boxes = F.pad(top_boxes, (0, 0, 0, kk - k_l))
                top_scores = F.pad(top_scores, (0, kk - k_l), value=_NEG)
                top_valid = F.pad(top_valid, (0, kk - k_l))
            lvl_boxes.append(top_boxes)
            lvl_scores.append(top_scores)
            lvl_valid.append(top_valid)

        boxes_lk = torch.stack(lvl_boxes, dim=1)      # [B, L, K, 4]
        scores_lk = torch.stack(lvl_scores, dim=1)    # [B, L, K]
        valid_lk = torch.stack(lvl_valid, dim=1)
        sel, sel_valid = nms(boxes_lk, scores_lk, kk,
                             cfg.rpn_proposal_nms_thres, valid=valid_lk)
        sel_c = sel.clamp_min(0)
        boxes = torch.where(sel_valid[..., None],
                            _gather_rows(boxes_lk, sel_c), 0.0).reshape(
                                b, -1, 4)
        scores = torch.where(sel_valid, torch.gather(scores_lk, -1, sel_c),
                             _NEG).reshape(b, -1)
        valid = sel_valid.reshape(b, -1)
        _, top_idx = sort_desc_stable(scores, min(kk, boxes.shape[1]))
        return _gather_rows(boxes, top_idx), torch.gather(valid, 1, top_idx)

    def _roi_align_batched(self, p23456, boxes, pool: int, valid=None):
        """FPN ROIAlign over the batch -> [B, N, pool, pool, C] f32, invalid
        slots 0 (JAX faster_rcnn.py:451-490); the training dispatch of
        :462-482 (module note)."""
        cfg = self.config
        feats = list(p23456[:4])
        strides = cfg.anchor_strides[:4]
        impl = cfg.roi_align_impl
        if cfg.is_train and impl == "pallas":
            impl = cfg.roi_align_train_impl
            if impl == "pallas":
                return multilevel_roi_align_trainable(feats, boxes, strides,
                                                      pool)
        fn = (multilevel_roi_align_cuda if impl == "pallas"
              else multilevel_roi_align)
        return fn(feats, boxes, strides, pool, valid=valid)

    def _apply_head(self, roi_feats: torch.Tensor,
                    boxes: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None):
        """Box head over [B, K, 7, 7, C] features as one flat batch (JAX
        faster_rcnn.py:492-514); with ``add_relation_nn`` the relation
        residuals need the slots' ``boxes`` [B, K, 4] and attend within
        each image, over its ``valid`` slots (ROADMAP C14)."""
        b, k = roi_feats.shape[:2]
        roi_flat = roi_feats.reshape(b * k, 7, 7, -1).to(self.compute_dtype)
        label_out, box_out = self.fastrcnn(roi_flat, boxes, valid)
        return (label_out.reshape(b, k, -1).float(),
                box_out.reshape(b, k, -1, 4).float())

    def _predictions(self, decoded, probs, prop_valid):
        """Batched per-class NMS + global top-R (JAX ``_predictions_single``,
        faster_rcnn.py:516-566). decoded [B, K, C-1, 4] clipped boxes, probs
        [B, K, C], prop_valid [B, K]. Returns final (boxes [B, R, 4], labels
        [B, R] int32, probs [B, R], valid [B, R], class_idx [B, R])."""
        cfg = self.config
        r = cfg.result_per_im
        b, k = decoded.shape[:2]
        boxes_t = decoded.transpose(1, 2)              # [B, C-1, K, 4]
        probs_t = probs[:, :, 1:].transpose(1, 2)      # [B, C-1, K]
        vmask = prop_valid[:, None, :] & (probs_t > cfg.result_score_thres)

        # per-class top-kc preselect (identical greedy result unless a class
        # keeps > kc/2 boxes)
        kc = min(2 * r, k)
        masked = torch.where(vmask, probs_t, torch.full_like(probs_t, _NEG))
        sel_probs, sel_idx = sort_desc_stable(masked, kc)
        sel_boxes = _gather_rows(boxes_t, sel_idx)
        sel_valid = torch.gather(vmask, -1, sel_idx)

        idx, val = nms(sel_boxes, sel_probs, r, cfg.fastrcnn_nms_iou_thres,
                       valid=sel_valid)                # [B, C-1, r]
        idx_c = idx.clamp_min(0)
        cls_boxes = torch.where(val[..., None], _gather_rows(sel_boxes, idx_c),
                                0.0)
        cls_probs = torch.where(val, torch.gather(sel_probs, -1, idx_c), _NEG)

        flat_probs = cls_probs.reshape(b, -1)
        flat_valid = val.reshape(b, -1)
        flat_boxes = cls_boxes.reshape(b, -1, 4)
        kf = min(r, flat_probs.shape[1])
        top_p, top_i = sort_desc_stable(
            torch.where(flat_valid, flat_probs, _NEG), kf)
        final_valid = torch.gather(flat_valid, 1, top_i)
        final_boxes = torch.where(final_valid[..., None],
                                  _gather_rows(flat_boxes, top_i), 0.0)
        class_idx = (top_i // r).to(torch.int32)       # 0..C-2
        final_labels = torch.where(final_valid, class_idx + 1, 0).to(
            torch.int32)
        final_probs = torch.where(final_valid, top_p, 0.0)
        if kf < r:  # pad up to R
            pad = r - kf
            final_boxes = F.pad(final_boxes, (0, 0, 0, pad))
            final_labels = F.pad(final_labels, (0, pad))
            final_probs = F.pad(final_probs, (0, pad))
            final_valid = F.pad(final_valid, (0, pad))
            class_idx = F.pad(class_idx, (0, pad))
        return final_boxes, final_labels, final_probs, final_valid, class_idx

    # ------------------------------------------------------------------
    # full forward

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Batched inference. images: [B, h, w, 3] BGR (uint8 or float,
        0-255) or [B, 3h/2, w] planar I420 uint8, on the model's device.
        Returns a dict of [B, ...] outputs."""
        cfg = self.config
        if images.dim() == 3:
            b, w = images.shape[0], images.shape[2]
            h = images.shape[1] * 2 // 3
        else:
            b, h, w = images.shape[:3]
        hp, wp, fields, valids = self._static_geometry(h, w)

        p23456 = self.backbone(self.preprocess(images, hp, wp))
        label_logits, box_logits = self._rpn_all_levels(p23456)
        prop_boxes, prop_valid = self._proposals(
            label_logits, box_logits, fields, valids, h, w)

        k = prop_boxes.shape[1]
        roi_feats = self._roi_align_batched(p23456, prop_boxes, 7,
                                            valid=prop_valid)
        label_out, box_out = self._apply_head(roi_feats, prop_boxes,
                                              prop_valid)

        if cfg.use_frcnn_class_agnostic:
            box_out = box_out.expand(b, k, self.num_out_class - 1, 4)
        if self.partial_label_idx is not None:
            label_out = label_out[:, :, self.partial_label_idx]
            if not cfg.use_frcnn_class_agnostic:
                box_out = box_out[:, :, self.partial_box_idx, :]

        reg_w = self.reg_w
        decoded = decode_boxes(box_out / reg_w, prop_boxes[:, :, None, :],
                               cfg.bbox_decode_clip)
        decoded = clip_boxes(decoded, (h, w))
        probs = torch.softmax(label_out, dim=-1)

        so_out = ({} if self.small_objects is None else
                  self._small_object_outputs(p23456, decoded, probs,
                                             prop_valid, h, w))
        fb, fl, fp, fv, fci = self._predictions(decoded, probs, prop_valid)
        box_feat = self._roi_align_batched(p23456, fb, 7, valid=fv)
        out = {
            "final_boxes": fb,
            "final_labels": fl,
            "final_probs": fp,
            "final_valid": fv,
            # the only form the trackers consume (deep_sort/utils.py:27-28)
            "pooled_box_feat": box_feat.mean(dim=(2, 3)),
        }
        if self.keep_full_box_feat:
            out["fpn_box_feat"] = box_feat
        out.update(so_out)
        if self.maskrcnn is not None:
            out["final_masks"] = self._masks(p23456, fb, fv, fci)
        return out

    def _masks(self, p23456, boxes, valid, class_idx) -> torch.Tensor:
        """Mask R-CNN branch (JAX faster_rcnn.py:643-655): a 14x14 ROIAlign
        over the final boxes, the head in the compute dtype, each
        detection's mask picked by its class index (clipped), sigmoid.
        Returns [B, R, 28, 28] float32."""
        b, r = boxes.shape[:2]
        roi = self._roi_align_batched(p23456, boxes, 14, valid=valid)
        logits = self.maskrcnn(roi.reshape(b * r, 14, 14, -1).to(
            self.compute_dtype)).float().reshape(b, r, 28, 28, -1)
        sel = class_idx.long().clamp(0, logits.shape[-1] - 1)
        picked = torch.gather(
            logits, -1, sel[:, :, None, None, None].expand(b, r, 28, 28, 1))
        return torch.sigmoid(picked[..., 0])

    # ------------------------------------------------------------------
    # small-object heads

    def _so_core(self, p23456, dec, probs, valid):
        """JAX ``_so_core`` (faster_rcnn.py:354-407) batched over images and
        SO classes, shared by inference and training. dec [B, K, C-1, 4]
        clipped boxes (with their gradient in training), probs [B, K, C],
        valid [B, K]. One NMS over [B, n_so, K] (scores ``probs[..., c+1]``,
        no threshold) keeps R = result_per_im boxes a class, and one more
        over the person column the ``so_person_topk`` references; one
        7x7 ROIAlign of both through fc6/fc7 in float32; the person
        relation over the valid slots (ROADMAP C18); a 2-way dense a class.
        Returns (so_boxes [B, n_so, R, 4], so_valid [B, n_so, R], so_logits
        [B, n_so, R, 2] float32)."""
        cfg = self.config
        r = cfg.result_per_im
        n_so = len(self.so_ids)
        b, k = dec.shape[:2]
        ids = self.so_idx
        cand = dec[:, :, ids].transpose(1, 2)                 # [B, n_so, K, 4]
        scores = probs[:, :, ids + 1].transpose(1, 2).detach()
        idx, so_valid = nms(cand.detach(), scores, r,
                            cfg.fastrcnn_nms_iou_thres,
                            valid=valid[:, None, :].expand(b, n_so, k))
        so_boxes = torch.where(so_valid[..., None],
                               _gather_rows(cand, idx.clamp_min(0)), 0.0)
        boxes = so_boxes.reshape(b, n_so * r, 4)
        box_valid = so_valid.reshape(b, n_so * r)
        if cfg.use_so_association:
            pid = cfg.classname2id.get("Person", 1) - 1
            person = dec[:, :, pid]
            pidx, ref_valid = nms(person.detach(),
                                  probs[:, :, pid + 1].detach(),
                                  cfg.so_person_topk,
                                  cfg.fastrcnn_nms_iou_thres, valid=valid)
            ref_boxes = torch.where(ref_valid[..., None],
                                    _gather_rows(person, pidx.clamp_min(0)),
                                    0.0)
            boxes = torch.cat([boxes, ref_boxes], 1)
            box_valid = torch.cat([box_valid, ref_valid], 1)
        hidden = self._so_fc(p23456, boxes.contiguous(), box_valid)
        so_hidden = hidden[:, :n_so * r]
        if cfg.use_so_association:
            so_hidden = so_hidden + person_object_relation(
                self.small_objects["person_object_relation"], so_hidden,
                boxes[:, :n_so * r], ref_boxes, hidden[:, n_so * r:],
                valid=so_valid.reshape(b, n_so * r), ref_valid=ref_valid)
        so_hidden = so_hidden.reshape(b, n_so, r, -1)
        so_logits = torch.stack([
            dense(self.small_objects[f"small_object_classification_c{i + 1}"],
                  so_hidden[:, i].reshape(b * r, -1)).reshape(b, r, 2)
            for i in range(n_so)], 1)
        return so_boxes, so_valid, so_logits

    def _so_fc(self, p23456, boxes, valid):
        """The SO heads' ``roi_head`` (JAX faster_rcnn.py:366-372): a 7x7
        ROIAlign of boxes [B, N, 4] (kernel B1 in one launch; in training
        the trainable version, whose backward also gives the boxes their
        gradient) through fc6/fc7 with relu, all in float32. Returns
        [B, N, fc_dim]. A padded slot is a zero box, whose samples all lie
        outside the map, so its features are 0 with or without ``valid``."""
        b, n = boxes.shape[:2]
        rf = self._roi_align_batched(p23456, boxes, 7, valid=valid)
        hid = torch.relu(dense(self.fastrcnn.fc6, rf.reshape(b * n, 7, 7, -1)))
        return torch.relu(dense(self.fastrcnn.fc7, hid)).reshape(b, n, -1)

    def _small_object_outputs(self, p23456, decoded, probs, prop_valid,
                              h: int, w: int) -> Dict[str, torch.Tensor]:
        """JAX ``_small_object_outputs`` (faster_rcnn.py:409-446): each
        slot's [n_so + 1] label logits, the background averaged over the
        classes; softmax; candidates that NMS dropped zeroed (and those at
        or under ``result_score_thres`` with ``use_so_score_thres``); then
        the per-class NMS and global top-R of ``_predictions`` with every
        row valid. Returns so_final_boxes [B, R, 4], so_final_labels [B, R]
        (1..n_so, indexing ``config.small_objects``' present names),
        so_final_probs [B, R], so_final_valid [B, R]."""
        cfg = self.config
        so_boxes, so_valid, so_logits = self._so_core(p23456, decoded, probs,
                                                      prop_valid)
        bg = so_logits[..., 0].mean(1)                        # [B, R]
        label_logits = torch.cat([bg[..., None],
                                  so_logits[..., 1].transpose(1, 2)], -1)
        so_probs = torch.softmax(label_logits, dim=-1)
        boxes_t = clip_boxes(so_boxes.transpose(1, 2), (h, w))
        every = torch.ones_like(bg, dtype=torch.bool)
        keep = torch.cat([every[..., None], so_valid.transpose(1, 2)], -1)
        so_probs = torch.where(keep, so_probs, 0.0)
        if cfg.use_so_score_thres:
            so_probs = torch.where(so_probs > cfg.result_score_thres,
                                   so_probs, 0.0)
        fb, fl, fp, fv, _ = self._predictions(boxes_t, so_probs, every)
        return {"so_final_boxes": fb, "so_final_labels": fl,
                "so_final_probs": fp, "so_final_valid": fv}

    def _so_train_loss(self, p23456, roi_boxes, roi_valid, label_out,
                       box_out, gt_boxes, gt_labels, gt_valid, h: int,
                       w: int) -> torch.Tensor:
        """JAX ``_so_train_loss`` (faster_rcnn.py:823-866): the SO
        candidates rebuilt from the box head's outputs (their gradient
        kept), each labelled fg where its IOU with a gt box of its class is
        at least ``fastrcnn_fg_thres``; softmax CE over each class's valid
        rows, averaged over the classes, then over the images."""
        cfg = self.config
        reg_w = self.reg_w
        box_full = box_out
        if cfg.use_frcnn_class_agnostic:
            box_full = box_out.expand(*box_out.shape[:2], cfg.num_class - 1,
                                      4)
        decoded = clip_boxes(decode_boxes(box_full / reg_w,
                                          roi_boxes[:, :, None, :],
                                          cfg.bbox_decode_clip), (h, w))
        probs = torch.softmax(label_out, dim=-1)
        so_boxes, so_valid, so_logits = self._so_core(p23456, decoded, probs,
                                                      roi_valid)
        total = 0.0
        for i, c in enumerate(self.so_ids):
            cls_gt = gt_valid & (gt_labels == c + 1)           # [B, G]
            iou = pairwise_iou(so_boxes[:, i].detach(), gt_boxes)
            iou = torch.where(cls_gt[:, None, :], iou, 0.0)
            lab = (iou.max(-1).values >= cfg.fastrcnn_fg_thres).long()
            ce = loss_lib.softmax_ce(so_logits[:, i], lab)     # [B, R]
            n_valid = so_valid[:, i].sum(-1).clamp_min(1)
            total = total + torch.where(so_valid[:, i], ce, 0.0).sum(-1) \
                / n_valid
        return (total / len(self.so_ids)).mean()

    @torch.inference_mode()
    def extract_box_feat(self, images: torch.Tensor, boxes: torch.Tensor
                         ) -> torch.Tensor:
        """The feature extractor alone (JAX faster_rcnn.py:663-674; the
        reference's RCNN_FPN_givenbox): images [B, h, w, 3] BGR and boxes
        [B, N, 4] in image coordinates -> mean-pooled 7x7 ROI features
        [B, N, C] float32. The ROIAlign takes every box (no validity mask),
        through kernel B1 with roi_align_impl="pallas"."""
        b, h, w = images.shape[:3]
        hp, wp, _, _ = self._static_geometry(h, w)
        p23456 = self.backbone(self.preprocess(images, hp, wp))
        boxes = boxes.to(device=images.device,
                         dtype=torch.float32).contiguous()
        return self._roi_align_batched(p23456, boxes, 7).mean(dim=(2, 3))

    # ------------------------------------------------------------------
    # training forward

    def forward_train(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                      gt_masks: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Dict[str, torch.Tensor]] = None,
                      sync_group=None) -> Dict[str, torch.Tensor]:
        """Training losses (JAX faster_rcnn.py:679-781). images [B, h, w, 3]
        BGR; gt_boxes [B, G, 4] padded; gt_labels [B, G] int (1..C-1);
        gt_valid [B, G] bool; gt_masks optional [B, G, Ms, Ms] box-local
        instance masks (the mask loss, with ``add_mask``). The random
        subsamples draw from ``generator``, or take ``noise``: uniform draws
        "rpn_fg", "rpn_bg" [B, NA] (NA anchors over all levels) and
        "frcnn_fg", "frcnn_bg" [B, K + G] (K train proposals). Returns
        scalar losses and their sum, "total_loss". Every loss is a mean
        over images and the BNs are frozen, so a data-parallel step's ranks
        need nothing of each other here: ``sync_group`` (EfficientDet's
        signature) is not read."""
        cfg = self.config
        noise = noise or {}
        b, h, w = images.shape[:3]
        hp, wp, fields, valids = self._static_geometry(h, w)

        p23456 = self.backbone(self.preprocess(images, hp, wp))
        label_logits, box_logits = self._rpn_all_levels(p23456)

        # ---- RPN losses over the flat all-level anchor set
        flat_anchors = torch.cat(fields, dim=0)
        flat_label_logits = torch.cat([x.reshape(b, -1)
                                       for x in label_logits], dim=1)
        flat_box_logits = torch.cat([x.reshape(b, -1, 4)
                                     for x in box_logits], dim=1)
        labels, tboxes = target_lib.anchor_targets(
            flat_anchors, gt_boxes, gt_valid, (h, w), cfg.rpn_batch_per_im,
            cfg.rpn_fg_ratio, cfg.positive_anchor_thres,
            cfg.negative_anchor_thres, u_fg=noise.get("rpn_fg"),
            u_bg=noise.get("rpn_bg"), generator=generator)
        safe_t = torch.where((labels == 1)[..., None], tboxes,
                             flat_anchors.expand_as(tboxes))
        rpn_loss = loss_lib.rpn_losses(
            labels, safe_t, flat_anchors, flat_label_logits, flat_box_logits,
            cfg.rpn_batch_per_im, use_focal=cfg.focal_loss)

        # ---- proposals (train top-k) + target sampling
        prop_boxes, prop_valid = self._proposals(
            label_logits, box_logits, fields, valids, h, w)
        samples = target_lib.sample_fastrcnn_targets(
            prop_boxes, prop_valid, gt_boxes, gt_labels, gt_valid,
            cfg.fastrcnn_batch_per_im, cfg.fastrcnn_fg_ratio,
            cfg.fastrcnn_fg_thres, u_fg=noise.get("frcnn_fg"),
            u_bg=noise.get("frcnn_bg"), generator=generator)

        # unit boxes on padded rows keep encode finite under autograd:
        # torch.where, like jnp.where, passes the other branch's NaN
        # gradients
        unit = torch.tensor([0.0, 0.0, 1.0, 1.0], device=images.device)
        roi_boxes = torch.where(samples["valid"][..., None],
                                samples["boxes"], unit).contiguous()
        roi_feats = self._roi_align_batched(p23456, roi_boxes, 7)
        label_out, box_out = self._apply_head(roi_feats, roi_boxes,
                                              samples["valid"])

        reg_w = self.reg_w
        fg_gt_safe = torch.where(samples["fg"][..., None],
                                 samples["fg_gt_boxes"], roi_boxes)
        enc_fg = encode_boxes(fg_gt_safe, roi_boxes) * reg_w
        frcnn_loss = loss_lib.fastrcnn_losses(
            samples["labels"], label_out, enc_fg, box_out, samples["valid"],
            samples["fg"], use_focal=cfg.focal_loss)

        losses = {k: v.mean() for k, v in {**rpn_loss, **frcnn_loss}.items()}
        if self.small_objects is not None:
            losses["so_label_loss"] = self._so_train_loss(
                p23456, roi_boxes, samples["valid"], label_out, box_out,
                gt_boxes, gt_labels, gt_valid, h, w)
        if self.maskrcnn is not None and gt_masks is not None:
            losses["mrcnn_loss"] = self._mask_train_loss(
                p23456, roi_boxes, samples, gt_masks)
        losses["total_loss"] = sum(losses.values())
        return losses

    def _mask_train_loss(self, p23456, roi_boxes, samples, gt_masks
                         ) -> torch.Tensor:
        """Mask R-CNN training loss (JAX faster_rcnn.py:783-821): the head
        on the fg sample slots only (packed first), 28x28 targets resampled
        from each fg row's matched box-local gt mask onto its roi box."""
        cfg = self.config
        s = roi_boxes.shape[1]
        fg_cap = min(int(cfg.fastrcnn_batch_per_im * cfg.fastrcnn_fg_ratio),
                     s)
        fg_boxes = roi_boxes[:, :fg_cap].contiguous()
        fg_flags = samples["fg"][:, :fg_cap]
        fg_labels = samples["labels"][:, :fg_cap]
        fg_gt_idx = samples["fg_gt_idx"][:, :fg_cap].long()
        fg_gt_boxes = samples["fg_gt_boxes"][:, :fg_cap]
        # keep the coordinate map well-conditioned on padded rows
        unit = torch.tensor([0.0, 0.0, 1.0, 1.0], device=roi_boxes.device)
        safe_gt = torch.where(fg_flags[..., None], fg_gt_boxes, unit)

        b = fg_boxes.shape[0]
        mask_feats = self._roi_align_batched(p23456, fg_boxes, 14)
        mask_logits = self.maskrcnn(mask_feats.reshape(
            b * fg_cap, 14, 14, -1).to(self.compute_dtype)).float()
        mask_logits = mask_logits.reshape(b, fg_cap, 28, 28, -1)

        ms = gt_masks.shape[-1]
        picked = torch.gather(gt_masks.float(), 1, fg_gt_idx[
            :, :, None, None].expand(b, fg_cap, ms, ms))
        tgt = loss_lib.crop_mask_to_roi(picked, safe_gt, fg_boxes)
        tgt = (tgt >= 0.5).float()
        return loss_lib.maskrcnn_loss(mask_logits, fg_labels, fg_flags,
                                      tgt).mean()
