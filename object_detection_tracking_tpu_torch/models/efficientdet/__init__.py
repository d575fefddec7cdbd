"""EfficientDet (d0-d7), the inference forward (port of
object_detection_tracking_tpu/models/efficientdet): EfficientNet backbone
-> BiFPN -> shared separable class/box nets over P3-P7 -> sigmoid, global
top-k, decode, per-class exact NMS -> level-indexed ROIAlign tracking
features."""

from .efficientdet import EfficientDet, EFFICIENTDET_CONFIGS  # noqa: F401
from .anchors import (decode_effdet_boxes, effdet_anchors,  # noqa: F401
                      encode_effdet_boxes)
