"""Training of the port (object_detection_tracking_tpu/train): losses,
on-device target assignment and the optimizer with optax's semantics."""

from .trainer import Optimizer, Trainer, make_lr_schedule  # noqa: F401
