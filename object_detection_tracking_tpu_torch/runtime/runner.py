"""Pipelined detector execution: overlap the host->device copy, device
compute and the device->host readback (port of
object_detection_tracking_tpu/runtime/runner.py:21-287).

PyTorch launches CUDA work asynchronously, so the runner keeps a small
in-flight window: while batch i computes, batch i+1's copy runs on a side
stream from pinned host memory, and batch i-1's small outputs come back
into pinned buffers behind an event. The JAX runner's transfer formats —
the temporal delta encode of uint8 frames and the uint16 packing of the
outputs — existed for a slow, compressed host link to a TPU and change no
value, so they are not ported; the bf16 rounding of the embeddings (and,
with ``config.add_mask``, of the mask probabilities, JAX runner.py:163-166,
:197-199) is kept, because the trackers and the JSON writer see its
values.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from ..parallel.mesh import on_device, replicate, split_batch


class DetectionRunner:
    """Runs a detector module over batches with software pipelining.

    Usage:
        runner = DetectionRunner(model)
        for host_out, meta in runner.run(batch_iter):  # meta passthrough
            ...

    With more than one of ``devices``, each batch that divides over them is
    split over one replica of ``model`` per device (parallel/mesh.py
    ``replicate`` and ``split_batch``; JAX: the batch sharded over its
    mesh, runner.py:35-84), and the outputs come back in batch order; a
    batch that does not divide runs on the first device. Each replica's
    copies and forward run with its card as the current device.
    """

    FETCH_KEYS = ("final_boxes", "final_labels", "final_probs",
                  "final_valid", "pooled_box_feat")

    def __init__(self, model, depth: int = 2, emb_agg: str = "average",
                 ship_full_feat: bool = False, devices=None):
        self.replicas = [model] if devices is None or len(devices) < 2 \
            else replicate(model, [torch.device(d) for d in devices])
        self.model = self.replicas[0]
        self.device = self.model.device
        self.depth = max(1, depth)
        # tracking-embedding aggregation over the 7x7 ROI feature grid
        # (reference obj_detect_tracking_multi_queuer_tmot.py:512-525):
        # average (default) | max | spatial (channel-mean -> 49-d)
        if emb_agg in ("avg", "average"):
            emb_agg = "average"
        elif emb_agg not in ("max", "spatial"):
            raise ValueError(f"unknown emb_agg {emb_agg!r}")
        self.emb_agg = emb_agg
        # --get_box_feat: also read back the full [R, 7, 7, C] features
        self.ship_full_feat = ship_full_feat
        self._cuda = self.device.type == "cuda"
        self._copy_streams = {r.device: torch.cuda.Stream(r.device)
                              for r in self.replicas
                              if r.device.type == "cuda"}

    def _upload(self, images: np.ndarray, device: torch.device):
        """Start the copy of one batch to ``device``; returns (device
        tensor, host tensor that must live until the copy is done)."""
        host = torch.from_numpy(np.ascontiguousarray(images))
        if device.type != "cuda":
            return host.to(device), host
        host = host.pin_memory()
        compute = torch.cuda.current_stream(device)
        stream = self._copy_streams[device]
        with torch.cuda.stream(stream):
            dev = host.to(device, non_blocking=True)
        compute.wait_stream(stream)
        dev.record_stream(compute)
        return dev, host

    def _forward(self, model, images: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        out = model(images)
        b, r = out["final_boxes"].shape[:2]
        if self.emb_agg != "average" or self.ship_full_feat:
            if "fpn_box_feat" not in out:
                raise ValueError(
                    "emb_agg max/spatial and ship_full_feat need the model "
                    "to output the full 7x7 ROI features (fpn_box_feat)")
        pooled = out["pooled_box_feat"]
        if self.emb_agg == "max":
            pooled = out["fpn_box_feat"].amax(dim=(2, 3))
        elif self.emb_agg == "spatial":
            pooled = out["fpn_box_feat"].mean(dim=-1).reshape(b, r, -1)
        fetch = {k: out[k] for k in self.FETCH_KEYS}
        # the embeddings travel as bf16, like the JAX runner's readback,
        # so the trackers see the same rounded values
        fetch["pooled_box_feat"] = pooled.to(torch.bfloat16)
        if "final_masks" in out:   # config.add_mask
            fetch["final_masks"] = out["final_masks"].to(torch.bfloat16)
        if self.ship_full_feat:
            fetch["fpn_box_feat"] = out["fpn_box_feat"].to(torch.bfloat16)
        return fetch

    @staticmethod
    def _to_host_async(fetch: Dict[str, torch.Tensor], device):
        if device.type != "cuda":
            return fetch, None
        # non_blocking device->host copies land in pinned memory
        host = {k: v.to("cpu", non_blocking=True) for k, v in fetch.items()}
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        return host, done

    @staticmethod
    def _finish(parts) -> Dict[str, np.ndarray]:
        outs = []
        for host, done in parts:
            if done is not None:
                done.synchronize()
            outs.append({k: (v.float() if v.dtype == torch.bfloat16
                             else v).numpy() for k, v in host.items()})
        if len(outs) == 1:
            return outs[0]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def run(self, batches: Iterable[Tuple[np.ndarray, object]]
            ) -> Iterator[Tuple[Dict[str, np.ndarray], object]]:
        """batches yields (images [B, H, W, 3] or [B, 3H/2, W] uint8, meta).
        Yields (host numpy outputs, meta) in order, ``depth`` batches behind
        the newest one launched."""
        it = iter(batches)
        uploaded: deque = deque()
        inflight: deque = deque()

        def fill() -> bool:
            try:
                images, meta = next(it)
            except StopIteration:
                return False
            parts = []
            for r, x in split_batch(self.replicas, images):
                with on_device(r.device):
                    parts.append((r, self._upload(x, r.device)))
            uploaded.append((parts, meta))
            return True

        more = True
        for _ in range(self.depth + 1):
            more = fill()
            if not more:
                break
        while uploaded:
            parts, meta = uploaded.popleft()
            pending = []
            for r, (dev, _) in parts:
                with on_device(r.device):
                    pending.append(self._to_host_async(self._forward(r, dev),
                                                       r.device))
            inflight.append((pending, meta, parts))
            if more:
                more = fill()
            if len(inflight) >= self.depth:
                pending, meta, _ = inflight.popleft()
                yield self._finish(pending), meta
        while inflight:
            pending, meta, _ = inflight.popleft()
            yield self._finish(pending), meta
