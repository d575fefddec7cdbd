"""The synthetic shapes dataset in memory, drawn with numpy alone.

``generate_dataset`` renders the scenes of ``data/synthetic.py
generate_dataset`` (colored circles, squares and triangles on textured
backgrounds) with no image codec and no cv2: a machine without them trains
and evaluates the detector quality proof on the same scenes. It consumes
``np.random.RandomState(seed)`` in the same order, so names, boxes, labels,
colors and the 28x28 masks are the file writer's, bit for bit, and the
background's noise and gradient too. The shapes and the distractor strokes
are rasterised with OpenCV's integer rules (``drawing.cpp``: the midpoint
filled circle, the edge-list polygon fill with its 8-connected outline,
the fixed-point convex fill of a thick line with round caps).

``generate_video`` renders ``synthetic.py generate_video``'s moving-shapes
clip (the tracking proof's video) and its ground truth the same way, into
an in-memory ``VideoReader``; ``generate_video_dataset`` samples such clips
into training scenes as ``synthetic.py generate_video_dataset`` does.

One difference stays: the file writer stores each image as JPEG at quality
95 and each clip as mp4, and the proofs trained and tracked on their
decodes; here every frame is the lossless render (ROADMAP C11, C12).

``MemoryDetectionDataset`` batches the scenes as ``DetectionTrainDataset``
batches files: the same shuffle and flip order, box scaling, label mapping,
masks and padding.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple

import numpy as np

from ..ops.boxes import get_new_hw
from .training import DetectionTrainDataset
from .video import VideoReader

SHAPE_CLASSES = ("Person", "Vehicle", "Bike")   # circle, square, triangle

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


class Scene(NamedTuple):
    """One rendered image: its name, the [H, W, 3] uint8 BGR render, and
    the annotation the file writer's ``.npz`` holds (``boxes`` float32
    [G, 4], ``labels`` class-name strings [G], ``masks`` float32
    [G, 28, 28])."""
    name: str
    image: np.ndarray
    anno: Dict[str, np.ndarray]


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img, y: int, x1: int, x2: int, color) -> None:
    """Pixels x1..x2 (inclusive) of row y, clipped to the image."""
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def _put(img, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _clip_line(w, h, x1, y1, x2, y2):
    """OpenCV's ``clipLine`` on a w x h canvas: the clipped ends, or None
    when the segment misses it."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _line8(img, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """An 8-connected line between integer points (``LineIterator`` with
    left-to-right order)."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0


def _line2(img, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """A line between 16.16 fixed-point points (OpenCV's ``Line2``)."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT,
         (y2 + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1, y1 >> XY_SHIFT, color)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1 >> XY_SHIFT, y1, color)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_circle(img, cx: int, cy: int, r: int, color) -> None:
    """A filled circle, 8-connected (OpenCV's midpoint ``Circle``)."""
    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _fill_convex(img, pts, color) -> None:
    """A convex polygon of 16.16 fixed-point points, outline included
    (OpenCV's ``FillConvexPoly`` at ``shift`` 16, 8-connected)."""
    h, w = img.shape[:2]
    npts = len(pts)
    half = XY_ONE >> 1
    imin = min(range(npts), key=lambda i: (pts[i][1], i))
    p0 = pts[-1]
    for p in pts:
        _line2(img, p0[0], p0[1], p[0], p[1], color)
        p0 = p
    xmin = (min(p[0] for p in pts) + half) >> XY_SHIFT
    xmax = (max(p[0] for p in pts) + half) >> XY_SHIFT
    ymin = (pts[imin][1] + half) >> XY_SHIFT
    ymax = (max(p[1] for p in pts) + half) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # edge = [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % npts
                while True:
                    edges -= 1
                    if edges + 1 <= 0:
                        break
                    ty = (pts[idx][1] + half) >> XY_SHIFT
                    if ty > y:
                        xs, xe = pts[idx0][0], pts[idx][0]
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            _hline(img, y, (edge[left][2] + half) >> XY_SHIFT,
                   (edge[right][2] + half) >> XY_SHIFT, color)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _fill_poly(img, pts, color) -> None:
    """A polygon of integer points, outline included (OpenCV's
    ``fillPoly``: ``CollectPolyEdges`` then ``FillEdgeCollection``)."""
    h, w = img.shape[:2]
    edges = []   # [y0, y1, x, dx]
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        _line8(img, x0, y0, x1, y1, color)
        if y0 != y1:
            dx = _cdiv((x1 - x0) << XY_SHIFT, y1 - y0)
            if y0 < y1:
                edges.append([y0, y1, x0 << XY_SHIFT, dx])
            else:
                edges.append([y1, y0, x1 << XY_SHIFT, dx])
        x0, y0 = x1, y1
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = min(max(e[1] for e in edges), h)
    for y in range(max(y_min, 0), y_max):
        # rows y0..y1-1 of each edge, at the edge's x on that row
        xs = sorted(e[2] + (y - e[0]) * e[3] for e in edges
                    if e[0] <= y < e[1])
        for a, b in zip(xs[0::2], xs[1::2]):
            _hline(img, y, (a + XY_ONE - 1) >> XY_SHIFT, b >> XY_SHIFT,
                   color)


def _thick_line(img, x1: int, y1: int, x2: int, y2: int, thickness: int,
                color) -> None:
    """``cv2.line`` with 8-connected ends (``ThickLine``, flags 3)."""
    if thickness <= 1:
        _line8(img, x1, y1, x2, y2, color)
        return
    p0 = (x1 << XY_SHIFT, y1 << XY_SHIFT)
    p1 = (x2 << XY_SHIFT, y2 << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (thick + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(p0[0] + dpx, p0[1] + dpy),
                           (p0[0] - dpx, p0[1] - dpy),
                           (p1[0] - dpx, p1[1] - dpy),
                           (p1[0] + dpx, p1[1] + dpy)], color)
    rad = (thick + (XY_ONE >> 1)) >> XY_SHIFT
    for px, py in (p0, p1):
        _fill_circle(img, (px + (XY_ONE >> 1)) >> XY_SHIFT,
                     (py + (XY_ONE >> 1)) >> XY_SHIFT, rad, color)


def _textured_background(rng, h: int, w: int) -> np.ndarray:
    base = rng.randint(40, 160, (3,), np.int32)
    yy = np.linspace(0, 30, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 30, w, dtype=np.float32)[None, :]
    grad = (yy + xx)[..., None]
    noise = rng.randn(h, w, 3).astype(np.float32) * 12
    img = np.clip(base[None, None] + grad * rng.uniform(-1, 1) + noise,
                  0, 255).astype(np.uint8)
    # distractor strokes (unlabeled clutter)
    for _ in range(rng.randint(2, 6)):
        p1 = (int(rng.randint(0, w)), int(rng.randint(0, h)))
        p2 = (int(rng.randint(0, w)), int(rng.randint(0, h)))
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        _thick_line(img, *p1, *p2, int(rng.randint(1, 3)), color)
    return img


def _shape_box(rng, h: int, w: int, cls: int, size_range=None, near=None):
    """The trial box of ``synthetic.py _draw_shape`` with its draws (the
    trial's drawing goes to a copy there, so nothing is drawn here)."""
    lo, hi = size_range or (14, min(h, w) // 3)
    size = int(rng.randint(lo, max(hi, lo + 1)))
    if near is not None:
        nx, ny = (near[0] + near[2]) / 2, (near[1] + near[3]) / 2
        x = int(np.clip(nx + rng.uniform(-1.5, 1.5) * size - size / 2,
                        2, w - size - 2))
        y = int(np.clip(ny + rng.uniform(-1.5, 1.5) * size - size / 2,
                        2, h - size - 2))
    else:
        x = int(rng.randint(2, w - size - 2))
        y = int(rng.randint(2, h - size - 2))
    rng.randint(0, 255, 3)   # the trial's color
    if cls == 0:
        r = size // 2
        return (x, y, x + 2 * r, y + 2 * r)
    return (x, y, x + size, y + size)


def _draw_shape_at(img, cls: int, box, rng) -> None:
    x1, y1, x2, y2 = [int(v) for v in box]
    color = tuple(int(c) for c in rng.randint(30, 255, 3))
    if cls == 0:
        r = (x2 - x1) // 2
        _fill_circle(img, x1 + r, y1 + r, r, color)
    elif cls == 1:
        # cv2.rectangle(thickness=-1): both corners inclusive
        img[max(y1, 0):y2 + 1, max(x1, 0):x2 + 1] = color
    else:
        _fill_poly(img, [((x1 + x2) // 2, y1), (x1, y2), (x2, y2)], color)


def shape_box_mask(cls: int, ms: int = 28) -> np.ndarray:
    """Box-local instance mask of a shape class on an ms x ms grid."""
    m = np.zeros((ms, ms), np.uint8)
    if cls == 0:      # circle inscribed in the box
        yy, xx = np.mgrid[0:ms, 0:ms].astype(np.float32) + 0.5
        r = ms / 2.0
        m[((yy - r) ** 2 + (xx - r) ** 2) <= r * r] = 1
    elif cls == 1:    # square fills the box
        m[:] = 1
    else:             # triangle (apex top-center)
        _fill_poly(m, [(ms // 2, 0), (0, ms - 1), (ms - 1, ms - 1)], 1)
    return m.astype(np.float32)


def _iou(a, b) -> float:
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    if inter == 0:
        return 0.0
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / float(area_a + area_b - inter)


def generate_dataset(num_images: int, image_hw=(160, 160),
                     max_objects: int = 4, seed: int = 0, prefix: str = "im",
                     with_masks: bool = True, size_range=None,
                     crowding: float = 0.0, overlap_iou: float = 0.3
                     ) -> List[Scene]:
    """The scenes ``synthetic.py generate_dataset`` writes for the same
    arguments, in memory: each a name, the BGR uint8 render and the
    annotation its ``.npz`` holds. ``size_range``, ``crowding``,
    ``overlap_iou`` and ``max_objects`` are the hard mode's knobs there."""
    rng = np.random.RandomState(seed)
    h, w = image_hw
    scenes = []
    for i in range(num_images):
        img = _textured_background(rng, h, w)
        boxes, labels, masks = [], [], []
        for _ in range(int(rng.randint(1, max_objects + 1))):
            cls = int(rng.randint(0, len(SHAPE_CLASSES)))
            near = (boxes[int(rng.randint(len(boxes)))]
                    if boxes and rng.uniform() < crowding else None)
            # reject heavy overlap so the gt stays unambiguous
            for _attempt in range(8):
                box = _shape_box(rng, h, w, cls, size_range, near)
                ok = all(_iou(box, b) < overlap_iou for b in boxes)
                if ok:
                    break
            if not ok:
                continue
            _draw_shape_at(img, cls, box, rng)
            boxes.append(box)
            labels.append(SHAPE_CLASSES[cls])
            masks.append(shape_box_mask(cls))
        anno = dict(boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels))
        if with_masks:
            anno["masks"] = np.asarray(masks, np.float32).reshape(
                -1, 28, 28)
        scenes.append(Scene(f"{prefix}{i:05d}", img, anno))
    return scenes


class MemoryVideo(VideoReader):
    """A ``VideoReader`` over frames held in memory; ``seek`` rewinds, so
    one render can be read more than once."""

    def __init__(self, frames: List[np.ndarray], fps: float = 30.0):
        self.frames = frames
        self.num_frames = len(frames)
        self.fps = fps
        self.pos = 0

    def read(self):
        if self.pos >= self.num_frames:
            return False, None
        self.pos += 1
        return True, self.frames[self.pos - 1]

    def seek(self, frame_idx: int):
        self.pos = frame_idx


def _render_clip(num_frames: int, image_hw, num_objects: int, seed: int,
                 size_range, speed_range):
    """The frames and ground truth of ``synthetic.py generate_video``, its
    draws in its order: returns ([H, W, 3] uint8 BGR frames, gt)."""
    rng = np.random.RandomState(seed)
    h, w = image_hw
    bg = _textured_background(rng, h, w)
    lo, hi = size_range or (18, min(h, w) // 4)
    objs = []
    for oid in range(num_objects):
        cls = int(rng.randint(0, len(SHAPE_CLASSES)))
        size = int(rng.randint(lo, max(hi, lo + 1)))
        for _ in range(20):   # spread the starting positions out
            x = float(rng.randint(2, w - size - 2))
            y = float(rng.randint(2, h - size - 2))
            if all(abs(x - o["x"]) > size or abs(y - o["y"]) > size
                   for o in objs):
                break
        vx, vy = rng.uniform(*speed_range, 2) * rng.choice([-1, 1], 2)
        color = tuple(int(c) for c in rng.randint(60, 255, 3))
        objs.append(dict(id=oid, cls=cls, size=size, x=x, y=y,
                         vx=float(vx), vy=float(vy), color=color))
    frames, gt = [], {}
    for t in range(num_frames):
        frame = bg.copy()
        frame_gt = []
        for o in objs:
            o["x"] += o["vx"]
            o["y"] += o["vy"]
            if o["x"] < 1 or o["x"] + o["size"] > w - 1:
                o["vx"] *= -1
                o["x"] = float(np.clip(o["x"], 1, w - o["size"] - 1))
            if o["y"] < 1 or o["y"] + o["size"] > h - 1:
                o["vy"] *= -1
                o["y"] = float(np.clip(o["y"], 1, h - o["size"] - 1))
            box = (o["x"], o["y"], o["x"] + o["size"], o["y"] + o["size"])
            x1, y1, x2, y2 = (int(round(v)) for v in box)
            if o["cls"] == 0:
                r = o["size"] // 2
                _fill_circle(frame, x1 + r, y1 + r, r, o["color"])
            elif o["cls"] == 1:
                # cv2.rectangle(thickness=-1): both corners inclusive
                frame[max(y1, 0):y2 + 1, max(x1, 0):x2 + 1] = o["color"]
            else:
                _fill_poly(frame, [((x1 + x2) // 2, y1), (x1, y2),
                                   (x2, y2)], o["color"])
            frame_gt.append((o["id"], box, SHAPE_CLASSES[o["cls"]]))
        frames.append(frame)
        gt[t] = frame_gt
    return frames, gt


def generate_video(num_frames: int = 150, image_hw=(160, 160),
                   num_objects: int = 4, seed: int = 0, size_range=None,
                   speed_range=(0.8, 2.2)):
    """The moving-shapes video of ``synthetic.py generate_video`` for the
    same arguments, in memory: the frames it hands its video writer, bit
    for bit, behind a ``MemoryVideo`` at 30 fps, and its ground truth
    {frame_idx: [(track_id, (x1, y1, x2, y2), class_name), ...]}. Returns
    (video, gt)."""
    frames, gt = _render_clip(num_frames, image_hw, num_objects, seed,
                              size_range, speed_range)
    return MemoryVideo(frames), gt


def generate_video_dataset(num_images: int, image_hw=(160, 160),
                           seed: int = 0, prefix: str = "vf",
                           num_objects: int = 5, size_range=None,
                           frames_per_video: int = 40,
                           sample_every: int = 2) -> List[Scene]:
    """The scenes ``synthetic.py generate_video_dataset`` writes for the
    same arguments: every ``sample_every``-th frame of clips rendered as
    ``generate_video`` renders them (clip ``vid`` from seed ``seed + 7919 *
    vid`` with ``2 + vid % (num_objects - 1)`` objects), named
    ``<prefix>_<vid>_<frame>``, with box-level ground truth (no masks).
    The pixels are the rendered frames, not their mp4 decodes."""
    scenes = []
    vid = 0
    while len(scenes) < num_images:
        n_before = len(scenes)
        frames, gt = _render_clip(
            frames_per_video, image_hw, 2 + (vid % max(num_objects - 1, 1)),
            seed + 7919 * vid, size_range, (0.8, 2.2))
        for fi, frame in enumerate(frames):
            if len(scenes) >= num_images:
                break
            if fi % sample_every == 0:
                anno = dict(
                    boxes=np.asarray([b for _, b, _ in gt[fi]],
                                     np.float32).reshape(-1, 4),
                    labels=np.asarray([c for _, _, c in gt[fi]]))
                scenes.append(Scene(f"{prefix}_{vid:03d}_{fi:04d}", frame,
                                    anno))
        if len(scenes) == n_before:
            raise RuntimeError(
                f"clip v{vid:03d} yielded no sampled frames "
                f"(frames_per_video={frames_per_video}, "
                f"sample_every={sample_every}); dataset generation "
                "cannot make progress")
        vid += 1
    return scenes


class MemoryDetectionDataset(DetectionTrainDataset):
    """``DetectionTrainDataset`` over rendered scenes: the same
    ``batches()``, with each sample taken from memory instead of a file.
    The scenes must be at the training size already (no resize)."""

    def __init__(self, scenes: List[Scene], classname2id, short_edge_size,
                 max_size, **kwargs):
        # an empty lst: the parent sets every attribute and finds no file
        super().__init__(os.devnull, "", "", classname2id, short_edge_size,
                         max_size, **kwargs)
        self.samples = [(s.image, s.anno) for s in scenes]
        self.num_samples = len(self.samples)

    def _load_one(self, im: np.ndarray, anno: Dict, flip: bool):
        """The parent's ``_load_one`` on an image and annotation in
        memory. Its body is copied, not called: the parent reads the image
        through its module's ``cv2`` (absent on the card) and the
        annotation through ``np.load``, and ``data/training.py`` stays the
        byte-for-byte copy it is. The copy must keep the parent's rules;
        ``tests/test_torch_quality.py`` holds the two datasets' batches
        equal."""
        h, w = im.shape[:2]
        se = self.short_edge_size
        if self.short_edge_jitter is not None and self.shuffle:
            lo, hi = self.short_edge_jitter
            se = self.rng.randint(lo, hi)
        neww, newh = get_new_hw(h, w, se, self.max_size)
        if (neww, newh) != (w, h):
            raise ValueError(
                f"scene of {w}x{h} needs a resize to {neww}x{newh}: render "
                "the scenes at the training size")
        sx, sy = neww / w, newh / h
        box_key, lab_key = ("actboxes", "actlabels") if self.act_as_obj \
            else ("boxes", "labels")
        boxes = np.array(anno[box_key], np.float32).reshape(-1, 4)
        boxes[:, 0::2] *= sx
        boxes[:, 1::2] *= sy
        labels = []
        for lab in anno[lab_key]:
            if isinstance(lab, bytes):
                lab = lab.decode()
            if isinstance(lab, str):
                lab = self.act_mapping.get(lab, lab)
                labels.append(self.classname2id.get(lab, -1))
            else:
                labels.append(int(lab))
        labels = np.asarray(labels, np.int32)
        masks = None
        if self.with_masks:
            ms = self.mask_size
            if "masks" in anno:
                masks = np.asarray(anno["masks"],
                                   np.float32).reshape(-1, ms, ms)
            else:
                masks = np.zeros((len(labels), ms, ms), np.float32)
        keep = labels > 0
        boxes, labels = boxes[keep], labels[keep]
        if masks is not None:
            masks = masks[keep]
        if flip:
            im = im[:, ::-1].copy()
            x1 = neww - boxes[:, 2]
            x2 = neww - boxes[:, 0]
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)
            if masks is not None:
                masks = masks[:, :, ::-1].copy()
        if masks is not None:
            return im, boxes, labels, masks
        return im, boxes, labels
