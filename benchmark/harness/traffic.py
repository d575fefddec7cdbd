"""The video traffic: a clip of moving rectangles served from a ring of
frames rendered in set-up, already at the model's size, in BGR.

A traffic file (``traffic/<name>.json``) gives the frame size, the frame
rate, the clip length, the ring length and the objects' count, sizes and
speeds; ``--seed`` draws where the objects start, how they move and their
colours. The rendering is that of the port's synthetic video (a grey
ramp, each object a filled rectangle moving at a constant velocity and
wrapping round the frame). The reader serves processed frame ``i`` (source
frame ``i * gap``) from ring slot ``i % ring``, and ends the clip at its
last frame or at a deadline, whichever comes first.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np


def render_ring(spec: dict, seed: int, gap: int) -> List[np.ndarray]:
    """The ring's frames [H, W, 3] uint8 for ``spec`` (a traffic file) and
    ``seed``: frame j shows the objects at source frame j * ``gap``."""
    if spec["kind"] != "ring_video":
        raise ValueError(f"no generator for traffic kind {spec['kind']!r}")
    h, w = spec["height"], spec["width"]
    rng = np.random.RandomState(int(seed) % (2 ** 32))
    ramp = np.linspace(40, 90, w).astype(np.uint8)
    base = np.ascontiguousarray(np.broadcast_to(ramp[None, :, None],
                                                (h, w, 3)))
    lo_w, hi_w = spec["object_width_share"]
    lo_h, hi_h = spec["object_height_share"]
    (vx_lo, vx_hi), (vy_lo, vy_hi) = spec["speed_px"]
    objs = [(rng.randint(0, w), rng.randint(0, h),
             rng.randint(vx_lo, vx_hi + 1), rng.randint(vy_lo, vy_hi + 1),
             rng.randint(int(w * lo_w), int(w * hi_w) + 1),
             rng.randint(int(h * lo_h), int(h * hi_h) + 1),
             rng.randint(0, 256, 3).astype(np.uint8))
            for _ in range(spec["objects"])]
    ring = []
    for j in range(spec["ring_frames"]):
        frame = base.copy()
        t = j * gap
        for x0, y0, vx, vy, ow, oh, color in objs:
            x = int(x0 + vx * t) % (w - ow)
            y = int(y0 + vy * t) % (h - oh)
            frame[y:y + oh, x:x + ow] = color
        ring.append(frame)
    return ring


def ring_frame(ring: List[np.ndarray], gap: int, index: int) -> np.ndarray:
    """The frame a clip serves at source frame ``index``."""
    return ring[(index // gap) % len(ring)]


class RingClip:
    """One clip through the port's ``VideoReader`` interface (``read``,
    ``grab``, ``release``, ``num_frames``, ``fps``): every ``gap``-th source
    frame is read from the ring, the others are grabbed for free; the clip
    ends after ``num_frames`` source frames or at ``deadline`` (a
    ``time.perf_counter()`` value)."""

    def __init__(self, ring: List[np.ndarray], gap: int, num_frames: int,
                 fps: float, deadline: Optional[float] = None):
        self.ring, self.gap = ring, gap
        self.num_frames, self.fps = num_frames, fps
        self.deadline = deadline
        self.i = 0

    def _more(self) -> bool:
        if self.i >= self.num_frames:
            return False
        return self.deadline is None or time.perf_counter() < self.deadline

    def read(self):
        if not self._more():
            return False, None
        frame = ring_frame(self.ring, self.gap, self.i)
        self.i += 1
        return True, frame

    def grab(self) -> bool:
        if not self._more():
            return False
        self.i += 1
        return True

    def release(self):
        pass
