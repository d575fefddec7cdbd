"""Video reading with frame-index fidelity (port of
object_detection_tracking_tpu/data/video.py:36-273).

The reference ships diva_io (PyAV) because OpenCV silently skips duplicated
frames in some AVI files, desynchronizing frame indices from annotations
(diva_io/video/reader.py:246-300). Two readers, as in the JAX module:

  * ``PyAVReader``: demux/decode via av with *frame reordering* (bounded
    heap on pts order) and *missing-frame fill* (duplicate the previous
    frame), diva_io's repair semantics; ``--use_lijun_video_loader``.
  * ``CV2Reader``: cv2.VideoCapture.

Both expose the cv2-style API: ``read() -> (ok, frame_bgr)``, ``num_frames``,
``fps``, ``release()``. ``open_video`` picks PyAV for ``.avi`` files when
``av`` imports and cv2 otherwise; asking for PyAV without it raises. cv2 is
optional at import, as in the JAX module: a machine without it can still
feed frames through a ``VideoReader`` of its own.
"""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

try:
    import av  # noqa: F401
    _HAS_AV = True
except ImportError:
    _HAS_AV = False


class VideoReader:
    """Abstract reader interface."""

    num_frames: int = 0
    fps: float = 0.0

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        raise NotImplementedError

    def grab(self) -> bool:
        """Advance one frame without returning pixels (cheaper than read
        for frame-gap skipping; falls back to read)."""
        ok, _ = self.read()
        return ok

    def seek(self, frame_idx: int):
        """Position so the next read() returns container frame frame_idx."""
        raise NotImplementedError

    def release(self):
        pass

    def __iter__(self):
        while True:
            ok, frame = self.read()
            if not ok:
                return
            yield frame


class CV2Reader(VideoReader):
    def __init__(self, path: str):
        if cv2 is None:
            raise RuntimeError("cv2 not available")
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video {path}")
        self.num_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0

    def read(self):
        ok, frame = self.cap.read()
        return ok, frame

    def grab(self):
        return self.cap.grab()

    def seek(self, frame_idx: int):
        self.cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)

    def release(self):
        self.cap.release()


class PyAVReader(VideoReader):
    """PyAV-based reader with reordering, missing-frame fill, and random
    seek — the diva_io repair semantics (diva_io/video/reader.py:224-300):

      * frames can arrive out of presentation order; a bounded lookahead
        heap (5 frames) re-sorts them by frame index (pts / pts-per-frame);
      * index gaps are filled by duplicating the previous frame (leading
        gaps duplicate the *next* frame backward), so ``read()`` call i
        always returns container frame i;
      * ``seek(i)`` seeks the container to the target pts and, if nothing
        decodes (landed past the last keyframe), retries stepping back
        ``retry_step`` frames up to ``retry`` times (reader.py:224-244).
    """

    BUFFER = 5

    def __init__(self, path: str, fix_missing: bool = True):
        import av
        self._av = av
        self.path = path
        self.fix_missing = fix_missing
        self.container = av.open(path)
        self.stream = self.container.streams.video[0]
        self.fps = float(self.stream.average_rate or 30.0)
        self.num_frames = int(self.stream.frames or 0)
        rate = self.stream.average_rate
        tb = self.stream.time_base
        self._pts_unit = (1 / (tb * rate)) if (tb and rate) else None
        self._serial = 0
        self._gen = self._frames(0)
        self.next_idx = 0

    # -- pipeline stages (decode -> reorder -> fix-missing) ---------------

    def _frame_index(self, frame) -> int:
        if self._pts_unit and frame.pts is not None:
            return int(round(frame.pts / self._pts_unit))
        i = self._serial
        return i

    def _decode(self):
        for packet in self.container.demux(self.stream):
            try:
                for frame in packet.decode():
                    yield frame
            except Exception:  # av.AVError: skip undecodable packets
                continue

    def _reorder(self):
        """Bounded lookahead heap on frame index (reader.py:291-300).

        Yields the *av frame object*, not pixels: BGR conversion happens
        lazily in read(), so grab() can skip frames without paying the
        YUV->BGR convert + copy (frame-gap skipping decodes but never
        converts skipped frames)."""
        buf = []
        for frame in self._decode():
            idx = self._frame_index(frame)
            heapq.heappush(buf, (idx, self._serial, frame))
            self._serial += 1
            if len(buf) > self.BUFFER:
                i, _, f = heapq.heappop(buf)
                yield i, f
        while buf:
            i, _, f = heapq.heappop(buf)
            yield i, f

    def _frames(self, start_idx: int):
        """Yield (idx, av_frame) for idx >= start_idx with gaps filled
        (reader.py:246-289). Gap fills re-yield the same frame object;
        read()'s one-entry conversion cache makes the duplicates free."""
        prev = None
        for idx, frame in self._reorder():
            if prev is None:
                if idx > start_idx and self.fix_missing:
                    # leading gap: duplicate the first real frame backward
                    for i in range(start_idx, idx):
                        yield i, frame
            else:
                pidx, pframe = prev
                if idx <= pidx:
                    continue  # duplicate pts after reorder; drop
                if idx - pidx > 1 and self.fix_missing:
                    for i in range(pidx + 1, idx):
                        if i >= start_idx:
                            yield i, pframe
            if idx >= start_idx:
                yield idx, frame
            prev = (idx, frame)

    # -- public API --------------------------------------------------------

    def _to_bgr(self, frame) -> np.ndarray:
        """Convert with a one-entry cache: consecutive gap-fill duplicates
        of the same frame object convert once."""
        cached = getattr(self, "_conv_cache", None)
        if cached is not None and cached[0] is frame:
            return cached[1]
        arr = frame.to_ndarray(format="bgr24")
        self._conv_cache = (frame, arr)
        return arr

    def read(self):
        try:
            idx, frame = next(self._gen)
        except StopIteration:
            return False, None
        self.next_idx = idx + 1
        return True, self._to_bgr(frame)

    def grab(self):
        """Advance one frame WITHOUT the YUV->BGR convert + copy — the
        decode still runs (codec frame dependency), but frame-gap
        skipping no longer pays conversion for frames it drops
        (CV2Reader.grab is cv2's native grab)."""
        try:
            idx, _ = next(self._gen)
        except StopIteration:
            return False
        self.next_idx = idx + 1
        return True

    def seek(self, frame_idx: int, retry: int = 5, retry_step: int = 120):
        """Random access with retry-backstep (reader.py:224-244). The next
        read() returns frame ``frame_idx``."""
        if frame_idx == 0:
            self.reset()
            return
        seek_to = frame_idx
        for _ in range(retry):
            pts = int(round(seek_to * self._pts_unit)) if self._pts_unit \
                else seek_to
            try:
                self.container.seek(pts, stream=self.stream)
            except Exception:
                self.reset()
                # fall through: decode from the start (always succeeds)
                self._gen = (x for x in self._frames(0)
                             if x[0] >= frame_idx)
                return
            gen = self._frames(frame_idx)
            try:
                first = next(gen)
            except StopIteration:
                seek_to -= retry_step
                if seek_to < 0:
                    seek_to = 0
                continue
            self._gen = _chain_one(first, gen)
            self.next_idx = frame_idx
            return
        raise RuntimeError(f"failed to seek to frame {frame_idx}")

    def reset(self):
        try:
            self.container.close()
        except Exception:
            pass
        self.container = self._av.open(self.path)
        self.stream = self.container.streams.video[0]
        self._serial = 0
        self._gen = self._frames(0)
        self.next_idx = 0

    def release(self):
        try:
            self.container.close()
        except Exception:
            pass


def _chain_one(first, rest):
    yield first
    yield from rest


def open_video(path: str, decoder: str = "auto") -> VideoReader:
    """decoder: auto | cv2 | pyav (reference --use_lijun_video_loader)."""
    if decoder == "pyav" or (decoder == "auto" and _HAS_AV and
                             path.lower().endswith(".avi")):
        if not _HAS_AV:
            raise RuntimeError("pyav decoder requested but av not installed")
        return PyAVReader(path)
    return CV2Reader(path)
