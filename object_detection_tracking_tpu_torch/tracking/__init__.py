"""Multi-object tracking: Deep SORT and the TMOT/JDE tracker (port of
object_detection_tracking_tpu/tracking).

Trackers run host-side on numpy, consuming the detections and the pooled
appearance embeddings that the detector returns. The modules are the JAX
package's host code, copied with their relative imports resolving into this
package (``tmot/`` byte for byte).
"""

from .deep_sort.tracker import Tracker  # noqa: F401
from .deep_sort import nn_matching  # noqa: F401
