"""Data and tensor parallelism (port of
object_detection_tracking_tpu/parallel): a (data, model) mesh of
``torch.distributed`` ranks, the sharded train step, the TP rule and the
inference fan-out over devices (mesh.py)."""

from .mesh import (  # noqa: F401
    make_mesh, make_sharded_train_step, param_shardings, replicate,
    split_batch)
