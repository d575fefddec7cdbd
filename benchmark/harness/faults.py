"""Faults planted under the timed path, for the tests and the control
study: each wraps a detector's ``forward`` so that a run through the video
driver must come out not correct."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def half_batch(model):
    """Half of each batch left out: the forward runs on the first half and
    its outputs stand in for the rest."""
    inner = model.forward

    def forward(images):
        b = images.shape[0]
        out = inner(images[:max(1, b // 2)])
        return {k: torch.cat([v] * (-(-b // v.shape[0])))[:b]
                for k, v in out.items()}
    model.forward = forward
    return model


def altered(model):
    """An answer altered where it is produced: each image's first
    detection moved 8 px to the right."""
    inner = model.forward

    def forward(images):
        out = dict(inner(images))
        boxes = out["final_boxes"].clone()
        boxes[:, 0, 0::2] += 8.0
        out["final_boxes"] = boxes
        return out
    model.forward = forward
    return model


class _LowerNmsThreshold(TorchDispatchMode):
    """Every call of N1's op ``odt::greedy_keep`` at half its IOU
    threshold."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.name() == "odt::greedy_keep":
            boxes, valid, thres = args
            args = (boxes, valid, 0.5 * thres)
        return func(*args, **(kwargs or {}))


def over_suppress(model):
    """A selection fault: N1's keep mask suppresses too much (both the
    RPN's and the per-class NMS at half their IOU threshold), so the
    program keeps genuine candidates, but not the reference's."""
    inner = model.forward

    def forward(images):
        with _LowerNmsThreshold():
            return inner(images)
    model.forward = forward
    return model


FAULTS = {"half_batch": half_batch, "altered": altered,
          "over_suppress": over_suppress}
