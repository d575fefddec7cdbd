"""ReID feature extractors of the port (object_detection_tracking_tpu/
models/reid): OSNet for persons, ResNet-50/101 for vehicles, as torchreid
builds them, loading torchreid ``.pth`` checkpoints with their own
state_dict names. The other nets of the JAX registry are ROADMAP A11b.
"""

from .extractor import FeatureExtractor  # noqa: F401
from .osnet import OSNet, OSNetAIN  # noqa: F401
from .resnet_reid import ResNetReID  # noqa: F401
