"""Box relation modules (Hu et al., "Relation Networks for Object
Detection"; port of object_detection_tracking_tpu/models/relation.py:21-94,
reference nn.py:115-330).

``relation_network``: grouped attention among one image's ROI features
with a log-geometric prior; ``person_object_relation``: the same from K
query boxes to R reference boxes (the small-object association head of
models/faster_rcnn.py ``_so_core``). Batched here: [B, K, D] features and
[B, K, 4] boxes, each image attending within itself.

Padded slots (ROADMAP C14, C18). The JAX model feeds the head every
proposal slot, and an invalid slot holds a zero box: ``geometric_encoding``
divides by its width, and the NaN reaches every query's softmax, so one
padded slot makes the whole image's head NaN. The reference feeds only the
NMS survivors (a dynamic count). ``relation_attend`` takes the references'
validity and leaves padded slots out of every softmax; a padded query's
own row gets 0, and so does every row of an image with no valid reference
(no reference, no message). Where every slot is valid this is JAX's
function; where some are padding, each valid row equals JAX's on the valid
boxes alone. Padded boxes are replaced by unit boxes before the encoding,
and an image without a valid reference keeps its (unit-box) references in
the softmax before its rows are zeroed, so no NaN or inf reaches the graph
(autograd would turn a masked one into a NaN gradient). A valid box of
zero width or height is not guarded, as in JAX.

Types as in JAX under a bfloat16 head: the geometry and the attention
weights are float32 (the boxes are), the query/key logits in the
features' dtype, the result float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .layers import linear


class Relation(nn.Module):
    """Parameters ``geo_emb``, ``geo_conv``, ``query_linear``,
    ``key_linear``, ``output_linear`` as in the JAX tree; the last three
    have no bias, and ``output_linear`` maps the flattened groups
    [group * D] to D (JAX relation.py:33-35)."""

    def __init__(self, feat_dim: int = 1024, group: int = 16,
                 geo_feat_dim: int = 64):
        super().__init__()
        self.group = group
        self.geo_emb = nn.Linear(4, geo_feat_dim)
        self.geo_conv = nn.Linear(geo_feat_dim, group)
        self.query_linear = nn.Linear(feat_dim, feat_dim, bias=False)
        self.key_linear = nn.Linear(feat_dim, feat_dim, bias=False)
        self.output_linear = nn.Linear(group * feat_dim, feat_dim,
                                       bias=False)




def geometric_encoding(boxes: torch.Tensor, ref_boxes: torch.Tensor
                       ) -> torch.Tensor:
    """[..., K, 4] x [..., R, 4] -> [..., K, R, 4] log-relative geometry,
    the deltas over the reference's width (JAX relation.py:41-61)."""
    def parts(b):
        return ((b[..., 0] + b[..., 2]) * 0.5, (b[..., 1] + b[..., 3]) * 0.5,
                b[..., 2] - b[..., 0], b[..., 3] - b[..., 1])
    cx1, cy1, w1, h1 = parts(boxes)
    cx2, cy2, w2, h2 = parts(ref_boxes)
    w2r = w2[..., None, :]
    dx = torch.log(torch.clamp(
        torch.abs((cx1[..., :, None] - cx2[..., None, :]) / w2r), min=1e-3))
    dy = torch.log(torch.clamp(
        torch.abs((cy1[..., :, None] - cy2[..., None, :]) / w2r), min=1e-3))
    dw = torch.log(w1[..., :, None] / w2r)
    dh = torch.log(h1[..., :, None] / h2[..., None, :])
    return torch.stack([dx, dy, dw, dh], dim=-1)


def relation_attend(p: Relation, feat: torch.Tensor, boxes: torch.Tensor,
                    ref_feat: torch.Tensor, ref_boxes: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    ref_valid: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Grouped attention [B, K, D] -> [B, K, D] (float32) over [B, R, D]
    references (JAX relation.py:64-84); ``valid`` [B, K] and ``ref_valid``
    [B, R] mark the real slots (module note)."""
    b, k, d = feat.shape
    r = ref_feat.shape[1]
    group = p.group
    gd = d // group
    unit = torch.zeros(4, device=boxes.device)    # [0, 0, 1, 1], no sync
    unit[2:] = 1.0
    if valid is not None:
        boxes = torch.where(valid[..., None], boxes, unit)
    if ref_valid is not None:
        ref_boxes = torch.where(ref_valid[..., None], ref_boxes, unit)

    geo = geometric_encoding(boxes.float(), ref_boxes.float())  # [B,K,R,4]
    geo = torch.tanh(linear(p.geo_emb, geo))
    geo = linear(p.geo_conv, geo)                               # [B,K,R,G]
    geo_w = torch.clamp(torch.relu(geo), min=1e-6).transpose(2, 3)

    q = linear(p.query_linear, feat).reshape(b, k, group, gd)
    kk = linear(p.key_linear, ref_feat).reshape(b, r, group, gd)
    logits = torch.einsum("bkgd,brgd->bkgr", q, kk) / math.sqrt(gd)
    logits = torch.log(geo_w) + logits.float()                   # [B,K,G,R]
    if ref_valid is not None:
        any_ref = ref_valid.any(-1, keepdim=True)                # [B, 1]
        drop = ~ref_valid & any_ref
        logits = logits.masked_fill(drop[:, None, None, :], float("-inf"))
        valid = (any_ref if valid is None else valid & any_ref).expand(b, k)
    weighted = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgr,brd->bkgd", weighted, ref_feat.float())
    out = linear(p.output_linear, out.reshape(b, k, group * d))
    if valid is not None:
        out = torch.where(valid[..., None], out, 0.0)
    return out


def relation_network(p: Relation, feat: torch.Tensor, boxes: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-relation among each image's boxes (JAX relation.py:87-89)."""
    return relation_attend(p, feat, boxes, feat, boxes, valid, valid)


def person_object_relation(p: Relation, feat, boxes, ref_boxes, ref_feat,
                           valid: Optional[torch.Tensor] = None,
                           ref_valid: Optional[torch.Tensor] = None):
    """K small-object queries attending to R person boxes (JAX
    relation.py:92-94), over the valid slots of each (module note)."""
    return relation_attend(p, feat, boxes, ref_feat, ref_boxes, valid,
                           ref_valid)
