"""ReID feature extractors of the port (object_detection_tracking_tpu/
models/reid), as torchreid builds them, loading torchreid ``.pth``
checkpoints with their own state_dict names: OSNet for persons, ResNet for
vehicles (the CLIs' defaults), and the SENet, IBN-Net, MobileNetV2,
DenseNet, SqueezeNet and ShuffleNetV2 families. The other nets of the JAX
registry are ROADMAP A11b.
"""

from .densenet_reid import DenseNetReID  # noqa: F401
from .extractor import FeatureExtractor  # noqa: F401
from .ibn_reid import IBNReID  # noqa: F401
from .mobilenetv2 import MobileNetV2ReID  # noqa: F401
from .osnet import OSNet, OSNetAIN  # noqa: F401
from .resnet_reid import ResNetReID  # noqa: F401
from .senet_reid import SENetReID  # noqa: F401
from .shufflenet_reid import ShuffleNetV2ReID  # noqa: F401
from .squeezenet_reid import SqueezeNetReID  # noqa: F401
