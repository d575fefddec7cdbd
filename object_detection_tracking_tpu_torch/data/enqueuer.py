"""Prefetch enqueuers feeding bounded queues (port of
object_detection_tracking_tpu/data/enqueuer.py:41-223; reference
VideoEnqueuer, enqueuer_thread.py:168-317, and DatasetEnqueuer,
enqueuer_thread.py:19-154).

``VideoEnqueuer``: a host thread reads frames, skips by frame gap, resizes
to (short edge, max size) and stacks batches of contiguous uint8 arrays
ready for one host->device copy. cv2 is needed only for a resize or the
I420 conversion: frames already at the target size in "bgr" format never
touch it.

``DatasetEnqueuer``: ordered prefetch over an indexable dataset (the image
CLI's ``ImageDataset``), its samples read by worker threads or, with
``use_process``, by spawned worker processes, batched by the dataset's
``collect_batch``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..ops.boxes import get_new_hw
from .video import VideoReader

_SENTINEL = object()

# the dataset of a spawned worker process (reference enqueuer.py's
# keras-derived shared-dataset globals, enqueuer.py:235-280)
_WORKER_DATASET = None


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get_sample(i):
    return _WORKER_DATASET.get_sample(i)


class VideoEnqueuer:
    """Decode thread: read frame -> skip by frame_gap -> resize to
    (short_edge_size, max_size) -> batch.

    ``get()`` yields (frames [b, H, W, 3] uint8 BGR — or [b, 3H/2, W]
    planar I420 — , scale, frame_indices); the last batch may be short, or
    zero-padded to the batch size with index -1 (``pad_last_batch``).
    """

    def __init__(self, vcap: VideoReader, short_edge_size: int,
                 max_size: int, frame_gap: int = 1, batch_size: int = 1,
                 prefetch: int = 10, start: bool = True,
                 pad_last_batch: bool = False, pixel_format: str = "bgr"):
        self.vcap = vcap
        self.short_edge_size = short_edge_size
        self.max_size = max_size
        self.frame_gap = frame_gap
        self.batch_size = batch_size
        self.pad_last_batch = pad_last_batch
        # "i420" ships planar YUV420 ([3h/2, w] uint8) — half the
        # host->device bytes; the detector converts to BGR on the device
        # with cv2's BT.601-video coefficients. "auto" picks i420 for even
        # frame sizes.
        self.pixel_format = pixel_format
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self.frames_read = 0
        self.orig_hw = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        if start:
            self.thread.start()

    def _run(self):
        cur_frame = 0
        batch_imgs: List[np.ndarray] = []
        batch_idx: List[int] = []
        scale = None
        try:
            while not self._stop.is_set():
                if cur_frame % self.frame_gap != 0:
                    # skipped frame: decode-advance without pixel conversion
                    if not self.vcap.grab():
                        break
                    cur_frame += 1
                    continue
                ok, frame = self.vcap.read()
                if not ok:
                    break
                h, w = frame.shape[:2]
                self.orig_hw = (h, w)
                neww, newh = get_new_hw(h, w, self.short_edge_size,
                                        self.max_size)
                if (neww, newh) != (w, h):
                    frame = cv2.resize(frame, (neww, newh),
                                       interpolation=cv2.INTER_LINEAR)
                scale = (newh * 1.0 / h + neww * 1.0 / w) / 2.0
                if self.pixel_format == "auto":
                    self.pixel_format = (
                        "i420" if (newh % 2 == 0 and neww % 2 == 0)
                        else "bgr")
                if self.pixel_format == "i420":
                    if newh % 2 or neww % 2:
                        raise ValueError(
                            "i420 pixel_format needs even frame dims, got "
                            f"{newh}x{neww}; use pixel_format='bgr'")
                    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2YUV_I420)
                batch_imgs.append(frame)
                batch_idx.append(cur_frame)
                self.frames_read += 1
                cur_frame += 1
                if len(batch_imgs) == self.batch_size:
                    self.queue.put((np.stack(batch_imgs), scale,
                                    list(batch_idx)))
                    batch_imgs, batch_idx = [], []
            if batch_imgs and not self._stop.is_set():
                if self.pad_last_batch:
                    while len(batch_imgs) < self.batch_size:
                        batch_imgs.append(np.zeros_like(batch_imgs[0]))
                        batch_idx.append(-1)
                self.queue.put((np.stack(batch_imgs), scale, list(batch_idx)))
        finally:
            self.queue.put(_SENTINEL)
            self.vcap.release()

    def get(self) -> Iterator[Tuple[np.ndarray, float, List[int]]]:
        while True:
            item = self.queue.get()
            if item is _SENTINEL:
                return
            yield item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass


class DatasetEnqueuer:
    """Ordered multi-worker prefetch over an indexable dataset (JAX
    data/enqueuer.py:143-223).

    dataset must provide ``num_samples``, ``get_sample(i)`` and
    ``collect_batch(samples)``; ``get()`` yields its batches of
    ``dataset.batch_size`` in order, the last one possibly short."""

    def __init__(self, dataset, prefetch: int = 5, num_workers: int = 1,
                 start: bool = True, use_process: bool = False):
        self.dataset = dataset
        self.batch_size = getattr(dataset, "batch_size", 1)
        self.queue: "queue.Queue" = queue.Queue(
            maxsize=prefetch * max(self.batch_size, 1))
        self._stop = threading.Event()
        self.num_workers = max(1, num_workers)
        # worker processes instead of threads (the reference's process
        # pool); threads are the default: cv2 releases the GIL, and the
        # dataset is shared without pickling
        self.use_process = use_process
        self.threads: List[threading.Thread] = []
        if start:
            self.start()

    def start(self):
        t = threading.Thread(target=self._run, daemon=True)
        t.start()
        self.threads.append(t)

    def _run(self):
        try:
            n = self.dataset.num_samples
            if self.num_workers > 1 and self.use_process:
                import multiprocessing
                # spawn, not fork: this process has live torch (and CUDA)
                # threads, and forking a threaded process can deadlock in
                # the child. Each worker re-imports the dataset's module;
                # the dataset ships pickled through initargs.
                ctx = multiprocessing.get_context("spawn")
                with ctx.Pool(self.num_workers, initializer=_init_worker,
                              initargs=(self.dataset,)) as pool:
                    for sample in pool.imap(_worker_get_sample, range(n)):
                        if self._stop.is_set():
                            break
                        self.queue.put(sample)
            elif self.num_workers > 1:
                from multiprocessing.pool import ThreadPool
                pool = ThreadPool(self.num_workers)
                for sample in pool.imap(self.dataset.get_sample, range(n)):
                    if self._stop.is_set():
                        break
                    self.queue.put(sample)
                pool.terminate()
            else:
                for i in range(n):
                    if self._stop.is_set():
                        break
                    self.queue.put(self.dataset.get_sample(i))
        finally:
            self.queue.put(_SENTINEL)

    def get(self):
        batch = []
        while True:
            item = self.queue.get()
            if item is _SENTINEL:
                break
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self.dataset.collect_batch(batch)
                batch = []
        if batch:
            yield self.dataset.collect_batch(batch)

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
