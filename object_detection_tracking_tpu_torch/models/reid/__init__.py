"""ReID feature extractors of the port (object_detection_tracking_tpu/
models/reid), as torchreid builds them, loading torchreid ``.pth``
checkpoints with their own state_dict names: every name of the JAX
registry (``extractor.MODELS``). OSNet for persons and ResNet for
vehicles are the CLIs' defaults; the SENet, IBN-Net, MobileNetV2,
DenseNet, SqueezeNet, ShuffleNet (v1 and v2), PCB, ResNet-50-mid, MLFN,
HA-CNN, MuDeep, Xception, Inception-v4, Inception-ResNet-v2 and
NASNet-A-Mobile families are the others.
"""

from .densenet_reid import DenseNetReID  # noqa: F401
from .extractor import FeatureExtractor  # noqa: F401
from .hacnn_reid import HACNNReID  # noqa: F401
from .ibn_reid import IBNReID  # noqa: F401
from .inceptionresnetv2_reid import InceptionResNetV2ReID  # noqa: F401
from .inceptionv4_reid import InceptionV4ReID  # noqa: F401
from .mlfn_reid import MLFNReID  # noqa: F401
from .mobilenetv2 import MobileNetV2ReID  # noqa: F401
from .mudeep_reid import MuDeepReID  # noqa: F401
from .nasnet_reid import NASNetAMobileReID  # noqa: F401
from .osnet import OSNet, OSNetAIN  # noqa: F401
from .pcb_reid import PCBReID  # noqa: F401
from .resnet_reid import ResNetReID  # noqa: F401
from .resnetmid_reid import ResNetMidReID  # noqa: F401
from .senet_reid import SENetReID  # noqa: F401
from .shufflenet_reid import ShuffleNetV2ReID  # noqa: F401
from .shufflenetv1_reid import ShuffleNetV1ReID  # noqa: F401
from .squeezenet_reid import SqueezeNetReID  # noqa: F401
from .xception_reid import XceptionReID  # noqa: F401
