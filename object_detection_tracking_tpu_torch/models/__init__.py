"""Detector models of the port (object_detection_tracking_tpu/models).

``get_model`` mirrors the JAX factory for the models ported so far; build
weights with params.init_params or load them with params.params_from_jax.
"""

from .faster_rcnn import FasterRCNNFPN  # noqa: F401


def get_model(config, model_name: str = None):
    if model_name is None:
        model_name = getattr(config, "model", "faster_rcnn")
    if model_name == "faster_rcnn":
        return FasterRCNNFPN(config)
    if model_name == "efficientdet":
        from .efficientdet import EfficientDet
        return EfficientDet(config)
    if model_name == "mask_rcnn":
        raise NotImplementedError(
            "mask_rcnn is not ported yet (ROADMAP A8)")
    raise ValueError(f"unknown model {model_name!r}")
