"""Typed configuration of the detector, the tracker and training: the
port's own copy of object_detection_tracking_tpu/config.py
(``DetectorConfig``, ``TrackerConfig``, ``TrainConfig``, ``RESNET_ARCH``,
with the same fields, defaults, presets and derived properties), so that
the port imports nothing of the JAX package. tests/test_torch_isolation.py
holds the two copies equal.

In the port, ``backbone_impl="pallas"`` runs each group's stride-1
bottleneck tail through the hand-written CUDA kernel
(ops/resnet_stage.py), ``roi_align_impl="pallas"`` the ROIAlign kernel
(ops/roi_align.py); "xla" names the plain PyTorch paths (cuDNN convs, the
exact ROIAlign gather). ``roi_align_train_impl`` keeps JAX's default,
"xla"; the port's train CLI sets "pallas", the kernel's forward and its
backward kernel (ROADMAP C9).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from . import class_ids


def _round_up(x: int, mult: int) -> int:
    return int(math.ceil(x / mult) * mult)


# ResNet depth -> (num_blocks, use_basic_block)
RESNET_ARCH = {
    18: ((2, 2, 2, 2), True),
    34: ((3, 4, 6, 3), True),
    50: ((3, 4, 6, 3), False),
    101: ((3, 4, 23, 3), False),
    152: ((3, 8, 36, 3), False),
}


@dataclass(frozen=True)
class DetectorConfig:
    """Faster/Mask-RCNN-FPN detector configuration.

    Field defaults mirror the reference inference defaults
    (obj_detect_tracking.py:300-388); shape-static fields are TPU additions.
    """

    # --- classes
    num_class: int = 16  # ActEV taxonomy incl. BG
    # name->id map key into class_ids, or "coco"
    class_map: str = "actev"
    # COCO-model partial-class inference (gather person/vehicle/bike heads)
    partial_classes: Tuple[str, ...] = ()

    # --- backbone
    resnet_depth: int = 101
    use_dilations: bool = False      # v3+: dilated conv in last 3 blocks/group
    use_se: bool = False             # v6: squeeze-excitation
    use_resnext: bool = False
    use_deformable: bool = False
    use_gn: bool = False
    freeze: int = 2                  # freeze up to cN during training

    # --- FPN / anchors
    fpn_num_channel: int = 256
    anchor_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)

    # --- RPN
    rpn_min_size: float = 0.0
    rpn_proposal_nms_thres: float = 0.7
    rpn_test_pre_nms_topk: int = 6000
    rpn_test_post_nms_topk: int = 1000   # also the per-level FPN topk
    # RPN per-level top-k selection: TPU-optimized approx_max_k when a
    # level has > 4k anchors (p2/p3 at 720p), exact lax.top_k otherwise.
    # Measured recall 0.98 at 0.95 target on the 176k-anchor p2; the
    # boxes near the k-th score boundary are the lowest-scoring proposals
    # and post-NMS AP is unchanged (quality gates retrain through this
    # path). 1.0 forces exact top_k everywhere (reference numerics).
    rpn_topk_recall: float = 0.95
    rpn_train_pre_nms_topk: int = 2000
    rpn_train_post_nms_topk: int = 2000
    rpn_batch_per_im: int = 256
    rpn_fg_ratio: float = 0.5
    positive_anchor_thres: float = 0.7
    negative_anchor_thres: float = 0.3

    # --- FastRCNN head
    fpn_frcnn_fc_head_dim: int = 1024
    use_frcnn_class_agnostic: bool = False   # v4+
    use_conv_frcnn_head: bool = False
    conv_frcnn_head_dim: int = 256
    add_relation_nn: bool = False
    use_att_frcnn_head: bool = False
    fastrcnn_bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    fastrcnn_nms_iou_thres: float = 0.5
    fastrcnn_batch_per_im: int = 512
    fastrcnn_fg_thres: float = 0.5
    fastrcnn_fg_ratio: float = 0.25
    result_score_thres: float = 0.0001
    result_per_im: int = 100

    # --- Mask head
    add_mask: bool = False
    mrcnn_head_dim: int = 256

    # --- losses
    focal_loss: bool = False

    # --- small-object heads (models.py:592-691; ActEV SO experiments)
    use_small_object_head: bool = False
    use_so_association: bool = False
    use_so_score_thres: bool = False
    so_person_topk: int = 10
    small_objects: Tuple[str, ...] = (
        "Prop", "Push_Pulled_Object", "Prop_plus_Push_Pulled_Object", "Bike")

    # --- image geometry (static for jit)
    short_edge_size: int = 1080
    max_size: int = 1920          # rounded up to fpn multiple in __post_init__

    # --- execution
    compute_dtype: str = "bfloat16"   # conv/matmul compute; params stay f32
    # "pallas": each group's stride-1 bottleneck tail through the
    # bottleneck-stage kernel (ops/resnet_stage.py), inference only;
    # "xla": the unfused blocks on cuDNN. The default flips only after a
    # measured A/B on the card (PERF.md).
    backbone_impl: str = "xla"
    # "pallas": the ROIAlign kernel (ops/roi_align.py); "xla": the exact
    # plain gather
    roi_align_impl: str = "pallas"
    # ROIAlign inside a train step: "pallas" is the trainable kernel
    # (ops/roi_align.py multilevel_roi_align_trainable), "xla" autograd of
    # the plain gather. JAX's default, kept; cli/main.py train sets
    # "pallas" (ROADMAP C9)
    roi_align_train_impl: str = "xla"
    # which model family get_model builds by default
    model: str = "faster_rcnn"
    # EfficientDet variant when model="efficientdet"
    efficientdet_name: str = "efficientdet-d0"
    # override the variant's square input size (0 = per-name default;
    # used by the synthetic quality gate to train d0 at small sizes)
    efficientdet_image_size: int = 0
    # global pre-NMS candidate cap (ref --efficientdet_max_detection_topk,
    # efficientdet_wrapper.py:242; reference commands use 5000)
    efficientdet_max_detection_topk: int = 5000
    mesh_axis_data: str = "data"
    mesh_axis_model: str = "model"

    # --- train flag (affects topk selection like the reference config)
    is_train: bool = False

    def __post_init__(self):
        mult = float(self.fpn_resolution_requirement)
        object.__setattr__(self, "max_size", _round_up(self.max_size, int(mult)))

    # ---- derived properties (reference derivations, kept as properties so
    # the dataclass stays hashable/serializable)

    @property
    def fpn_resolution_requirement(self) -> int:
        # stride of the coarsest backbone level used to build FPN (c5 = 32).
        return self.anchor_strides[3]

    @property
    def resnet_num_block(self) -> Tuple[int, ...]:
        return RESNET_ARCH[self.resnet_depth][0]

    @property
    def use_basic_block(self) -> bool:
        return RESNET_ARCH[self.resnet_depth][1]

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.anchor_ratios)

    @property
    def bbox_decode_clip(self) -> float:
        return math.log(self.max_size / 16.0)

    @property
    def num_levels(self) -> int:
        return len(self.anchor_strides)

    @property
    def classname2id(self) -> Dict[str, int]:
        if self.class_map == "coco":
            base = dict(class_ids.coco_obj_class_to_id)
        elif self.class_map == "actev":
            base = dict(class_ids.targetClass2id)
        elif self.class_map == "actev_mergeprop":
            base = dict(class_ids.targetClass2id_mergeProp)
        elif self.class_map == "activity":
            base = dict(class_ids.targetAct2id)
        elif self.class_map == "activity_bupt":
            base = dict(class_ids.targetAct2id_bupt)
        elif self.class_map == "activity_meva":
            base = dict(class_ids.targetAct2id_meva)
        else:
            raise ValueError(f"unknown class_map {self.class_map!r}")
        if self.partial_classes:
            names = ["BG"] + list(self.partial_classes)
            return {n: i for i, n in enumerate(names)}
        return base

    @property
    def classid2name(self) -> Dict[int, str]:
        return {v: k for k, v in self.classname2id.items()}

    # ---- static-shape helpers

    def pad_image_hw(self, h: int, w: int) -> Tuple[int, int]:
        """Static padded image size for a given (resized) frame size."""
        mult = self.fpn_resolution_requirement
        return _round_up(h, mult), _round_up(w, mult)

    def feature_hw(self, padded_hw: Tuple[int, int], level: int) -> Tuple[int, int]:
        s = self.anchor_strides[level]
        return padded_hw[0] // s, padded_hw[1] // s

    # ---- serialization

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DetectorConfig":
        d = json.loads(s)
        for k in ("anchor_strides", "anchor_sizes", "partial_classes"):
            if k in d:
                d[k] = tuple(d[k])
        for k in ("anchor_ratios", "fastrcnn_bbox_reg_weights"):
            if k in d:
                d[k] = tuple(float(x) for x in d[k])
        return cls(**d)

    # ---- reference "version" presets (obj_detect_tracking.py:265-280)

    @classmethod
    def from_version(cls, version: int, **overrides: Any) -> "DetectorConfig":
        presets: Dict[int, Dict[str, Any]] = {
            2: {},
            3: {"use_dilations": True},
            4: {"use_frcnn_class_agnostic": True, "use_dilations": True},
            5: {"use_frcnn_class_agnostic": True, "use_dilations": True},
            6: {"use_frcnn_class_agnostic": True, "use_se": True},
        }
        if version not in presets:
            raise ValueError(f"only versions 2-6 are supported, got {version}")
        kw = dict(presets[version])
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def coco(cls, **overrides: Any) -> "DetectorConfig":
        """COCO-trained model config (reference is_coco_model path)."""
        kw: Dict[str, Any] = {"num_class": 81, "class_map": "coco"}
        kw.update(overrides)
        return cls.from_version(2, **kw)

    @classmethod
    def coco_partial(cls, **overrides: Any) -> "DetectorConfig":
        """COCO model keeping only person/vehicle/bike heads
        (reference use_partial_classes, obj_detect_tracking.py:236-238)."""
        partial = tuple(class_ids.coco_obj_to_actev_obj.keys())
        kw: Dict[str, Any] = {
            "num_class": 81, "class_map": "coco", "partial_classes": partial}
        kw.update(overrides)
        return cls.from_version(2, **kw)


@dataclass(frozen=True)
class TrackerConfig:
    """Deep SORT / TMOT tracker configuration (deep_sort/tracker.py:40,
    tmot/multitracker.py:176-216)."""

    tracker: str = "deep_sort"            # or "tmot"
    metric: str = "cosine"
    max_cosine_distance: float = 0.5
    nn_budget: Optional[int] = 5
    max_iou_distance: float = 0.5
    max_age: int = 60
    n_init: int = 1
    # detection-level NMS before tracker update
    track_obj_nms_thres: float = 1.0      # 1.0 = off
    min_confidence: float = 0.85
    min_detection_height: float = 0.0
    frame_gap: int = 8
    # TMOT specifics
    emb_agg_method: str = "average"       # average | max | spatial
    track_buffer_seconds: float = 2.0
    fuse_lambda: float = 0.98
    emb_smooth_alpha: float = 0.9


@dataclass(frozen=True)
class TrainConfig:
    """Training schedule/optimizer config (reference trainer.py:49-98)."""

    optimizer: str = "momentum"
    init_lr: float = 0.003
    momentum: float = 0.9
    wd: float = 1e-4
    warmup_steps: int = 1000
    warmup_init_lr: float = 0.0003
    lr_schedule: str = "cosine"           # cosine | exp | constant
    total_steps: int = 360000
    clip_gradient_norm: Optional[float] = None
    train_batch_size: int = 1             # per device
    save_every_steps: int = 5000
    eval_every_steps: int = 5000
