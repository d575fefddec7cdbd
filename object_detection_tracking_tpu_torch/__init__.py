"""object_detection_tracking_tpu_torch — the PyTorch/CUDA port of
``object_detection_tracking_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference: every module here mirrors a
module there by path and name, and the tests hold each one against its JAX
counterpart on the CPU. This package imports torch, numpy and scipy, and
never jax, and nothing of the JAX package: it keeps its own copies of the
JAX-free pieces it needs (``config``, ``class_ids``, ``utils/masks``,
``utils/viz``, ``csrc/lapjv.cpp``).

Layout:
  params.py       JAX param pytree <-> the port's nn.Modules; JAX-free init
  native.py       builds csrc/ (nvcc) and the lapjv solver (g++), ctypes load
  ops/            box math, anchors, exact greedy NMS, frozen BN, ROIAlign
                  (plain torch spec + the hand-written CUDA kernel wrapper)
  models/         ResNet-FPN Faster-RCNN inference forward
  data/           cv2 video reading, the decode/resize enqueuer
  runtime/        DetectionRunner: pinned H2D, depth-2 pipeline
  tracking/       Deep SORT, Kalman filter, assignment (host numpy)
  cli/            obj_detect_tracking entry point
  csrc/           CUDA C++ kernels for sm_90a
"""

__version__ = "0.1.0"
