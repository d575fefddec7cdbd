"""Host data plane of the port: cv2 and PyAV video reading, the decode/resize
enqueuer, and the image-list dataset with its ordered prefetch
(object_detection_tracking_tpu/data)."""

from .video import VideoReader, open_video  # noqa: F401
from .datasets import ImageDataset  # noqa: F401
from .enqueuer import DatasetEnqueuer, VideoEnqueuer  # noqa: F401
