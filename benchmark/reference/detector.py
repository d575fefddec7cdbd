"""Plain float32 Faster/Mask R-CNN-FPN detector: the benchmark's reference.

It computes what the detector under test computes, from a configuration
file's ``model`` section and a flat weight tree (the benchmark's seeded
tree, keyed by the state names of the port's modules), with plain torch
operations only: ``F.conv2d``, ``F.linear``, a sequential greedy NMS and a
gather-based ROIAlign. It imports nothing of the program.

Semantics, from the input to the outputs:

* preprocess: BGR uint8 / 255, minus the ImageNet BGR mean, over its std,
  zero-padded to a multiple of 32;
* ResNet (bottleneck blocks): 7x7/2 stem padded (3, 2), a 3x3/2 max pool
  padded (1, 0) with -inf; a stride-2 3x3 is padded (1, 0) with no other
  padding, with dilation 2 (``dilated_c5``: c5's blocks) followed by one
  more zero row and column in front; frozen BN with eps 1e-5; a stride-2
  shortcut is a 1x1/2 with no padding;
* FPN: 1x1 laterals, nearest 2x top-down with the overhang cropped, 3x3
  outputs, p6 = every other pixel of p5; RPN: a shared 3x3 with relu, 1x1
  class (A) and box (4A) convs;
* proposals: per level the exact top-k of the anchors inside the image,
  decoded (log-size clip log(max_size / 16)), clipped to the image, kept
  where wider and taller than ``rpn_min_size``, a greedy NMS per level at
  ``rpn_nms_thres``, then the global top-k;
* ROIAlign: each box on its canonical FPN level, crop_and_resize sampling
  at 2P x 2P, the 2 x 2 mean; samples outside the map read 0;
* box head: fc6 (features flattened y, x, c), fc7, class and box outputs
  (class-agnostic or per class, the background row dropped; ``partial``:
  the COCO columns kept); decode with the regression weights, clip,
  softmax;
* predictions: per class, candidates above ``score_thres`` among the top
  2R, a greedy NMS at ``nms_thres`` keeping R, then the global top R;
* outputs: the final boxes, labels, scores and validity, the final boxes'
  7x7 features mean-pooled, and with masks the mask head's 28x28 sigmoid
  of each detection's class.

Sorts are stable and descending, so ties go to the lower index. Each conv
and linear layer can pass its input and weight through ``quant`` first:
the benchmark's lower-precision control.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
NEG = -1e30
BGR_MEAN = (0.406, 0.456, 0.485)
BGR_STD = (0.225, 0.224, 0.229)


@contextlib.contextmanager
def no_tf32():
    """float32 convs and matmuls in full float32 on the card."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale a tensor (its
    largest magnitude to 448), back in float32."""
    scale = x.abs().amax().float().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


# ---------------------------------------------------------------------------
# boxes


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE x / c (a Python scalar divisor becomes a reciprocal multiply on
    the card)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IOU [..., N, M] of x1y1x2y2 boxes, continuous areas."""
    b1, b2 = a[..., :, None, :], b[..., None, :, :]
    w = (torch.minimum(b1[..., 2], b2[..., 2])
         - torch.maximum(b1[..., 0], b2[..., 0])).clamp_min(0.0)
    h = (torch.minimum(b1[..., 3], b2[..., 3])
         - torch.maximum(b1[..., 1], b2[..., 1])).clamp_min(0.0)
    inter = w * h
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def decode(deltas: torch.Tensor, anchors: torch.Tensor,
           clip: float) -> torch.Tensor:
    wh = anchors[..., 2:4] - anchors[..., 0:2]
    ctr = (anchors[..., 2:4] + anchors[..., 0:2]) * 0.5
    size = torch.exp(torch.clamp(deltas[..., 2:4], max=clip)) * wh
    c = deltas[..., 0:2] * wh + ctr
    return torch.cat([c - size * 0.5, c + size * 0.5], dim=-1)


def clip_to(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    hi = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(boxes.clamp_min(0.0), hi)


def sort_desc(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape,
                                                     x.shape[-1]))


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                thres: float) -> torch.Tensor:
    """Greedy NMS keep mask [G, N] of score-sorted boxes [G, N, 4], one
    position after the other: a valid box is kept unless an earlier kept
    box overlaps it by more than ``thres``."""
    over = pairwise_iou(boxes, boxes) > thres
    keep = torch.zeros_like(valid)
    for i in range(boxes.shape[-2]):
        hit = (over[:, :i, i] & keep[:, :i]).any(-1)
        keep[:, i] = valid[:, i] & ~hit
    return keep


def nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
        thres: float, valid: torch.Tensor):
    """Greedy NMS over [..., N]: (indices [..., max_out] into the input,
    -1 padded, in descending score order; their validity)."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    masked = torch.where(valid, scores, torch.full_like(scores, NEG))
    order = torch.sort(masked, dim=-1, descending=True, stable=True)[1]
    bs = gather_rows(boxes, order).reshape(-1, n, 4)
    vs = torch.gather(valid, -1, order).reshape(-1, n)
    keep = greedy_keep(bs, vs, thres).reshape(*lead, n)
    rank = torch.cumsum(keep.long(), -1) - 1
    sel = keep & (rank < max_out)
    pos = torch.where(sel, rank, torch.full_like(rank, max_out))
    full = torch.full((*lead, max_out + 1), -1, dtype=torch.long,
                      device=scores.device)
    full.scatter_(-1, pos, order)
    out = full[..., :max_out]
    return out, out >= 0


# ---------------------------------------------------------------------------
# anchors (reference generate_anchors.py numerics: legacy rounding, +1)


def _whctrs(a):
    w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
    return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)


def _mk(ws, hs, xc, yc):
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack([xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                      xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)])


def cell_anchors(stride: int, size: float, ratios) -> np.ndarray:
    w, h, xc, yc = _whctrs(np.array([0, 0, stride - 1, stride - 1],
                                    np.float32))
    ratios = np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    base = _mk(ws, hs, xc, yc)
    scales = np.asarray([size], np.float64) / stride
    out = []
    for i in range(base.shape[0]):
        w, h, xc, yc = _whctrs(base[i])
        out.append(_mk(w * scales, h * scales, xc, yc))
    return np.vstack(out).astype(np.float32)


def anchor_field(stride: int, size: float, ratios, fh: int, fw: int
                 ) -> np.ndarray:
    cell = cell_anchors(stride, size, ratios)
    sx, sy = np.meshgrid(np.arange(fw, dtype=np.float32) * stride,
                         np.arange(fh, dtype=np.float32) * stride)
    shifts = np.stack([sx, sy, sx, sy], -1)
    field = (shifts[:, :, None, :] + cell[None, None]).astype(np.float32)
    field[..., 2:] += 1.0
    return field


# ---------------------------------------------------------------------------
# ROIAlign


def roi_levels(boxes: torch.Tensor) -> torch.Tensor:
    """Canonical FPN level 0..3 (p2..p5) of each box."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    root = torch.sqrt(area.clamp_min(0.0))
    lvl = torch.floor(4.0 + div(torch.log(div(root, 224.0) + 1e-6),
                                math.log(2.0)))
    return lvl.to(torch.int32).clamp(2, 5).long() - 2


def roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
              strides: Sequence[int], pool: int,
              valid: Optional[torch.Tensor] = None, chunk: int = 2048
              ) -> torch.Tensor:
    """feats NHWC [B, H_l, W_l, C] float32 per level, boxes [B, N, 4] in
    image coordinates -> [B, N, P, P, C] float32 (invalid slots 0)."""
    b, n = boxes.shape[:2]
    if n > chunk:
        parts = [roi_align(feats, boxes[:, i:i + chunk], strides, pool,
                           None if valid is None else valid[:, i:i + chunk],
                           chunk) for i in range(0, n, chunk)]
        return torch.cat(parts, 1)
    c = feats[0].shape[-1]
    dev = boxes.device
    lvl = roi_levels(boxes)
    flat = torch.cat([f.reshape(-1, c) for f in feats])
    sizes = [f.shape[1] * f.shape[2] for f in feats]
    base = torch.tensor([0] + [b * s for s in sizes[:-1]], device=dev
                        ).cumsum(0)
    hw = torch.tensor(sizes, device=dev)
    hs = torch.tensor([f.shape[1] for f in feats], device=dev)
    ws = torch.tensor([f.shape[2] for f in feats], device=dev)
    st = torch.tensor([float(s) for s in strides], device=dev)
    fb = boxes / st[lvl][..., None]
    s2 = 2 * pool
    grid = torch.arange(s2, dtype=torch.float32, device=dev) + 0.5

    def samples(lo, hi):
        return lo[..., None] + div(hi - lo, float(s2))[..., None] * grid \
            - 0.5
    iy = samples(fb[..., 1], fb[..., 3])[..., :, None].expand(b, n, s2, s2)
    ix = samples(fb[..., 0], fb[..., 2])[..., None, :].expand(b, n, s2, s2)
    h = hs[lvl].float()[..., None, None]
    w = ws[lvl].float()[..., None, None]
    inside = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
    y0f, x0f = torch.floor(iy), torch.floor(ix)
    fy, fx = (iy - y0f)[..., None], (ix - x0f)[..., None]
    hy, hx = (h - 1).long(), (w - 1).long()
    y0 = torch.minimum(y0f.long().clamp_min(0), hy)
    x0 = torch.minimum(x0f.long().clamp_min(0), hx)
    y1, x1 = torch.minimum(y0 + 1, hy), torch.minimum(x0 + 1, hx)
    img = torch.arange(b, device=dev)[:, None, None, None]
    row0 = base[lvl][..., None, None] + img * hw[lvl][..., None, None]
    wst = ws[lvl][..., None, None]

    def tap(y, x):
        idx = (row0 + y * wst + x).reshape(-1)
        return flat.index_select(0, idx).reshape(b, n, s2, s2, c)
    top = tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx
    bot = tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx
    out = torch.where(inside[..., None], top * (1 - fy) + bot * fy, 0.0)
    out = out.reshape(b, n, pool, 2, pool, 2, c).mean(dim=(3, 5))
    if valid is not None:
        out = torch.where(valid[:, :, None, None, None], out, 0.0)
    return out


# ---------------------------------------------------------------------------
# the detector


class ReferenceDetector:
    """The plain detector over ``tree`` (flat: state name -> tensor) and
    ``model`` (a configuration file's ``model`` section)."""

    def __init__(self, tree: Dict[str, torch.Tensor], model: dict,
                 quant: Optional[Callable] = None):
        self.m = dict(model)
        mult = model["fpn_multiple"]
        self.m.setdefault("decode_clip", math.log(
            -(-model["max_size"] // mult) * mult / 16.0))
        self.quant = quant
        self.t = tree
        self.strides = list(model["anchor_strides"])
        self.dev = next(iter(tree.values())).device

    # -- weights and layers

    def w(self, name: str) -> torch.Tensor:
        return self.t[name].float()

    def conv(self, prefix: str, x: torch.Tensor, stride: int = 1,
             pad=None, dilation: int = 1, bias: bool = True):
        """The conv whose weight is ``prefix.weight`` [O, I, k, k]; pad
        None = "same" for stride 1, else ((top, bottom), (left, right))."""
        wt = self.w(prefix + ".weight")
        k = wt.shape[-1]
        if pad is None:
            p = (k - 1) * dilation // 2
            pad = ((p, p), (p, p))
        (t, b), (l, r) = pad
        x = F.pad(x, (l, r, t, b))
        bb = self.t.get(prefix + ".bias") if bias else None
        if self.quant is not None:
            x, wt = self.quant(x), self.quant(wt)
        return F.conv2d(x, wt, None if bb is None else bb.float(), stride,
                        0, dilation)

    def bn(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        g, be = self.w(prefix + ".gamma"), self.w(prefix + ".beta")
        mu, var = self.w(prefix + ".mean"), self.w(prefix + ".variance")
        scale = g / torch.sqrt(var + BN_EPS)
        return x * scale.view(1, -1, 1, 1) \
            + (be - mu * scale).view(1, -1, 1, 1)

    def linear(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        wt = self.w(prefix + ".weight")
        if self.quant is not None:
            x, wt = self.quant(x), self.quant(wt)
        return F.linear(x, wt, self.w(prefix + ".bias"))

    # -- backbone, FPN, RPN

    def backbone(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[B, 3, Hp, Wp] -> [c2, c3, c4, c5]."""
        x = torch.relu(self.bn("resnet.conv0.bn", self.conv(
            "resnet.conv0", x, 2, ((3, 2), (3, 2)), bias=False)))
        x = F.max_pool2d(F.pad(x, (1, 0, 1, 0), value=float("-inf")), 3, 2)
        outs = []
        for gi, count in enumerate(self.m["resnet_blocks"]):
            dil = 2 if (self.m["dilated_c5"] and gi == 3) else 1
            for bi in range(count):
                stride = 2 if (gi > 0 and bi == 0) else 1
                d = dil if bi >= count - 3 else 1
                x = self.bottleneck(f"resnet.group{gi}.block{bi}", x, stride,
                                    d)
            outs.append(x)
        return outs

    def bottleneck(self, p: str, x, stride: int, dil: int):
        l = torch.relu(self.bn(p + ".conv1.bn",
                               self.conv(p + ".conv1", x, bias=False)))
        if stride == 2:
            l = self.conv(p + ".conv2", l, 2, ((1, 0), (1, 0)), dil,
                          bias=False)
            l = torch.relu(self.bn(p + ".conv2.bn", l))
            if dil != 1:
                l = F.pad(l, (1, 0, 1, 0))
        else:
            l = torch.relu(self.bn(p + ".conv2.bn", self.conv(
                p + ".conv2", l, dilation=dil, bias=False)))
        l = self.bn(p + ".conv3.bn", self.conv(p + ".conv3", l, bias=False))
        if p + ".convshortcut.weight" in self.t:
            sc = self.bn(p + ".convshortcut.bn", self.conv(
                p + ".convshortcut", x, stride, ((0, 0), (0, 0)),
                bias=False))
        else:
            sc = x
        return torch.relu(l + sc)

    def fpn(self, c2345: List[torch.Tensor]) -> List[torch.Tensor]:
        lat = [self.conv(f"fpn.lateral_1x1_c{i + 2}", c)
               for i, c in enumerate(c2345)]
        acc = [lat[3]]
        for i in (2, 1, 0):
            up = F.interpolate(acc[-1], scale_factor=2.0, mode="nearest")
            h, w = lat[i].shape[2:]
            acc.append(lat[i] + up[:, :, :h, :w])
        acc = acc[::-1]
        p = [self.conv(f"fpn.posthoc_3x3_p{i + 2}", a)
             for i, a in enumerate(acc)]
        return p + [p[-1][:, :, ::2, ::2]]

    def geometry(self, h: int, w: int):
        mult = self.m["fpn_multiple"]
        hp, wp = -(-h // mult) * mult, -(-w // mult) * mult
        fields, valids = [], []
        for li, s in enumerate(self.strides):
            if li < 4:
                fh, fw = hp // s, wp // s
            else:
                fh, fw = -(-(hp // 32) // 2), -(-(wp // 32) // 2)
            f = anchor_field(s, self.m["anchor_sizes"][li],
                             self.m["anchor_ratios"], fh, fw)
            v = np.zeros(f.shape[:3], bool)
            v[:min(fh, -(-h // s)), :min(fw, -(-w // s))] = True
            fields.append(torch.from_numpy(f.reshape(-1, 4)).to(self.dev))
            valids.append(torch.from_numpy(v.reshape(-1)).to(self.dev))
        return hp, wp, fields, valids

    def preprocess(self, images: torch.Tensor, hp: int, wp: int):
        """[B, h, w, 3] BGR uint8 -> [B, 3, hp, wp] normalised float32."""
        h, w = images.shape[1:3]
        mean = torch.tensor(BGR_MEAN, device=images.device)
        std = torch.tensor(BGR_STD, device=images.device)
        x = (images.float() * (1.0 / 255.0) - mean) / std
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        return x.permute(0, 3, 1, 2).contiguous()

    def features(self, images: torch.Tensor) -> dict:
        """The pyramid of ``images`` [B, h, w, 3]: p2..p6 NCHW, their NHWC
        views for ROIAlign, and the anchor geometry."""
        h, w = images.shape[1:3]
        hp, wp, fields, valids = self.geometry(h, w)
        p = self.fpn(self.backbone(self.preprocess(images, hp, wp)))
        return {"p": p, "nhwc": [x.permute(0, 2, 3, 1).contiguous()
                                 for x in p[:4]],
                "h": h, "w": w, "fields": fields, "valids": valids}

    def rpn(self, feat: dict):
        labels, boxes = [], []
        a = len(self.m["anchor_ratios"])
        for x in feat["p"]:
            hid = torch.relu(self.conv("rpn.conv0", x))
            lab = self.conv("rpn.class", hid).permute(0, 2, 3, 1)
            box = self.conv("rpn.box", hid).permute(0, 2, 3, 1)
            b, fh, fw, _ = box.shape
            labels.append(lab.reshape(b, -1))
            boxes.append(box.reshape(b, fh * fw * a, 4))
        return labels, boxes

    def proposals(self, feat: dict, topk: Optional[int] = None,
                  run_nms: bool = True):
        """(boxes [B, K, 4], valid [B, K]): with ``run_nms`` the detector's
        proposals; without, every level's top ``topk`` candidates before
        NMS (a superset of the proposals the detector can pick)."""
        m = self.m
        kk = topk or m["rpn_post_nms_topk"]
        h, w = feat["h"], feat["w"]
        labels, deltas = self.rpn(feat)
        lb, ls, lv = [], [], []
        for lvl in range(len(self.strides)):
            field, vm = feat["fields"][lvl], feat["valids"][lvl]
            scores = labels[lvl].float()
            k = min(kk, scores.shape[1])
            top_s, top_i = sort_desc(torch.where(vm, scores, NEG), k)
            bx = clip_to(decode(gather_rows(deltas[lvl].float(), top_i),
                                field[top_i], m["decode_clip"]), h, w)
            v = (vm[top_i] & (bx[..., 2] - bx[..., 0] > m["rpn_min_size"])
                 & (bx[..., 3] - bx[..., 1] > m["rpn_min_size"]))
            if k < kk:
                bx = F.pad(bx, (0, 0, 0, kk - k))
                top_s = F.pad(top_s, (0, kk - k), value=NEG)
                v = F.pad(v, (0, kk - k))
            lb.append(bx)
            ls.append(top_s)
            lv.append(v)
        boxes, scores, valid = (torch.stack(lb, 1), torch.stack(ls, 1),
                                torch.stack(lv, 1))
        b = boxes.shape[0]
        if not run_nms:
            return boxes.reshape(b, -1, 4), valid.reshape(b, -1)
        sel, sv = nms(boxes, scores, kk, m["rpn_nms_thres"], valid)
        sc = sel.clamp_min(0)
        boxes = torch.where(sv[..., None], gather_rows(boxes, sc), 0.0
                            ).reshape(b, -1, 4)
        scores = torch.where(sv, torch.gather(scores, -1, sc), NEG
                             ).reshape(b, -1)
        valid = sv.reshape(b, -1)
        _, top = sort_desc(scores, min(kk, boxes.shape[1]))
        return gather_rows(boxes, top), torch.gather(valid, 1, top)

    def box_head(self, feat: dict, boxes: torch.Tensor, valid: torch.Tensor,
                 chunk: int = 2048):
        """(decoded boxes [B, K, C-1, 4] clipped, probs [B, K, C]) of the
        box head over ``boxes``, C the output classes."""
        m = self.m
        b, k = boxes.shape[:2]
        logits, deltas = [], []
        for i in range(0, k, chunk):
            r = roi_align(feat["nhwc"], boxes[:, i:i + chunk], self.strides,
                          7, valid[:, i:i + chunk])
            x = r.reshape(-1, r[0, 0].numel())
            x = torch.relu(self.linear("fastrcnn.fc6", x))
            x = torch.relu(self.linear("fastrcnn.fc7", x))
            logits.append(self.linear("fastrcnn.outputs.class", x
                                      ).reshape(b, -1, m["num_class"]))
            deltas.append(self.linear("fastrcnn.outputs.box", x
                                      ).reshape(b, r.shape[1], -1, 4))
        label, box = torch.cat(logits, 1), torch.cat(deltas, 1)
        if not m["class_agnostic"]:
            box = box[:, :, 1:]
        if m.get("partial_label_idx"):
            dev = label.device
            label = label[:, :, torch.tensor(m["partial_label_idx"],
                                             device=dev)]
            if not m["class_agnostic"]:
                box = box[:, :, torch.tensor(m["partial_box_idx"],
                                             device=dev)]
        n_out = label.shape[-1]
        if m["class_agnostic"]:
            box = box.expand(b, k, n_out - 1, 4)
        reg = torch.tensor(m["reg_weights"], dtype=torch.float32,
                           device=box.device)
        dec = clip_to(decode(box / reg, boxes[:, :, None, :],
                             m["decode_clip"]), feat["h"], feat["w"])
        return dec, torch.softmax(label, -1)

    def predictions(self, dec, probs, valid):
        """Per-class NMS and the global top R: (boxes, labels, probs,
        valid, class index) [B, R, ...]."""
        m = self.m
        r = m["result_per_im"]
        b, k = dec.shape[:2]
        bt = dec.transpose(1, 2)
        pt = probs[:, :, 1:].transpose(1, 2)
        vm = valid[:, None, :] & (pt > m["score_thres"])
        kc = min(2 * r, k)
        sp, si = sort_desc(torch.where(vm, pt, NEG), kc)
        sb = gather_rows(bt, si)
        sv = torch.gather(vm, -1, si)
        idx, val = nms(sb, sp, r, m["nms_thres"], sv)
        ic = idx.clamp_min(0)
        cb = torch.where(val[..., None], gather_rows(sb, ic), 0.0)
        cp = torch.where(val, torch.gather(sp, -1, ic), NEG)
        fp, fv, fb = cp.reshape(b, -1), val.reshape(b, -1), cb.reshape(b, -1, 4)
        kf = min(r, fp.shape[1])
        tp, ti = sort_desc(torch.where(fv, fp, NEG), kf)
        valid_out = torch.gather(fv, 1, ti)
        boxes = torch.where(valid_out[..., None], gather_rows(fb, ti), 0.0)
        cls = ti // r
        labels = torch.where(valid_out, cls + 1, 0)
        scores = torch.where(valid_out, tp, 0.0)
        if kf < r:
            pad = r - kf
            boxes = F.pad(boxes, (0, 0, 0, pad))
            labels, scores = F.pad(labels, (0, pad)), F.pad(scores, (0, pad))
            valid_out, cls = F.pad(valid_out, (0, pad)), F.pad(cls, (0, pad))
        return boxes, labels, scores, valid_out, cls

    def pooled(self, feat: dict, boxes, valid) -> torch.Tensor:
        """Mean of the 7x7 ROIAlign features of ``boxes`` [B, N, C]."""
        return roi_align(feat["nhwc"], boxes, self.strides, 7, valid
                         ).mean(dim=(2, 3))

    def masks(self, feat: dict, boxes, valid, class_idx) -> torch.Tensor:
        """[B, R, 28, 28] sigmoid of each box's class mask."""
        b, r = boxes.shape[:2]
        x = roi_align(feat["nhwc"], boxes, self.strides, 14, valid)
        x = x.reshape(b * r, 14, 14, -1).permute(0, 3, 1, 2)
        for k in range(4):
            x = torch.relu(self.conv(f"maskrcnn.fcn{k}", x))
        wt = self.w("maskrcnn.deconv.weight")
        if self.quant is not None:
            x, wt = self.quant(x), self.quant(wt)
        # the JAX deconv: the stride-dilated input correlated with the
        # kernel unflipped, so as a transposed conv the kernel is flipped
        x = torch.relu(F.conv_transpose2d(
            x, wt.flip(2, 3).transpose(0, 1), self.w("maskrcnn.deconv.bias"),
            stride=2))
        logits = self.conv("maskrcnn.conv", x).permute(0, 2, 3, 1)
        logits = logits.reshape(b, r, 28, 28, -1)
        sel = class_idx.long().clamp(0, logits.shape[-1] - 1)
        picked = torch.gather(logits, -1, sel[:, :, None, None, None].expand(
            b, r, 28, 28, 1))[..., 0]
        return torch.sigmoid(picked)

    @torch.no_grad()
    def detect(self, images: torch.Tensor, feat: Optional[dict] = None
               ) -> Dict[str, torch.Tensor]:
        """The detector's outputs for ``images`` [B, h, w, 3] BGR uint8."""
        feat = feat or self.features(images)
        boxes, valid = self.proposals(feat)
        dec, probs = self.box_head(feat, boxes, valid)
        fb, fl, fp, fv, fc = self.predictions(dec, probs, valid)
        out = {"final_boxes": fb, "final_labels": fl, "final_probs": fp,
               "final_valid": fv,
               "pooled_box_feat": self.pooled(feat, fb, fv)}
        if self.m["mask"]:
            out["final_masks"] = self.masks(feat, fb, fv, fc)
        return out
