"""Greedy-NMS inputs shared by the CPU test against JAX
(tests/test_torch_nms_op.py) and the card test of kernel N1
(tests/test_torch_kernels_cuda.py); numpy only, no JAX."""

import numpy as np


def _random(rng, g, n, spread=200.0, size=60.0):
    xy = rng.uniform(0, spread, (g, n, 2))
    wh = rng.uniform(1, size, (g, n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def threshold_pairs(thres):
    """Pairs (box [0, 0, p, 1], box [0, 0, a, h]) whose float32 IOU, in
    pairwise_iou's operations, is just under float32(thres), on it and just
    over it: [3, 2, 4] boxes. (With p = 1 alone some of the three cannot be
    reached: the union's rounding skips them.)"""
    f32 = np.float32
    t = f32(thres)
    targets = (np.nextafter(t, f32(0)), t, np.nextafter(t, f32(1)))
    boxes = np.zeros((3, 2, 4), np.float32)
    found = [False] * 3
    for p in map(f32, (1, 1.25, 1.5, 2, 3, 5)):
        a = f32(1) - np.arange(2048, dtype=np.float32) / f32(8192)
        h0 = t * p / a
        h = h0[:, None] + (np.arange(-64, 65, dtype=np.float32)[None, :]
                           * np.spacing(h0)[:, None])
        a = np.broadcast_to(a[:, None], h.shape)
        inter = a * h
        iou = inter / ((p + inter) - inter)
        for i, target in enumerate(targets):
            hits = np.argwhere((iou == target) & (h < 1))
            if hits.size and not found[i]:
                r, c = hits[0]
                boxes[i] = [[0, 0, p, 1], [0, 0, a[r, c], h[r, c]]]
                found[i] = True
    assert all(found), f"no pair for IOU {thres} ({found})"
    return boxes


def make_case(name):
    """(boxes [G, N, 4], scores [G, N], valid [G, N], thres, max_out)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "ties":
        b = _random(rng, 3, 96)
        b[:, 1::3] = b[:, ::3][:, :b[:, 1::3].shape[1]]   # repeated boxes
        s = rng.randint(0, 4, (3, 96)).astype(np.float32) / 4  # tied scores
        v = rng.rand(3, 96) > 0.1
        return b, s, v, 0.5, 40
    if name == "all_overlapping":
        b = (np.array([20, 20, 120, 120], np.float32)
             + rng.uniform(-2, 2, (2, 150, 4))).astype(np.float32)
        s = rng.rand(2, 150).astype(np.float32)
        return b, s, np.ones((2, 150), bool), 0.7, 16
    if name == "all_invalid":
        b = _random(rng, 3, 64)
        s = rng.rand(3, 64).astype(np.float32)
        v = rng.rand(3, 64) > 0.5
        v[0] = False                       # a group with no valid box
        v[2] = False
        v[2, 63] = True                    # only the last one valid
        return b, s, v, 0.5, 20
    if name == "disjoint":
        # a grid of boxes that never overlap (some share an edge, where the
        # intersection's width is 0): every valid box is kept
        col, row = np.meshgrid(np.arange(12), np.arange(11))
        xy = np.stack([col.ravel(), row.ravel()], -1)[:130] * 20.0
        wh = rng.uniform(5, 20, (2, 130, 2))
        wh[:, ::7] = 20.0                  # edge to edge with the next cell
        xy = np.broadcast_to(xy, wh.shape)
        b = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        s = rng.rand(2, 130).astype(np.float32)
        return b, s, rng.rand(2, 130) > 0.1, 0.3, 130
    if name == "degenerate":
        # zero-area boxes (points, vertical and horizontal segments),
        # repeated ones (their union is 0), and boxes around them
        b = _random(rng, 3, 100, spread=60.0, size=20.0)
        b[:, ::4, 2] = b[:, ::4, 0]        # zero width
        b[:, 1::4, 3] = b[:, 1::4, 1]      # zero height
        b[:, 2::8, 2:] = b[:, 2::8, :2]    # points
        b[:, 50:60] = b[:, 40:50]          # repeated, zero-area among them
        s = rng.rand(3, 100).astype(np.float32)
        return b, s, rng.rand(3, 100) > 0.1, 0.0, 100
    if name == "negative_threshold":
        # 0 > thres: every pair suppresses, even disjoint boxes, so each
        # group keeps its best valid box alone
        b = _random(rng, 3, 80, spread=400.0, size=30.0)
        s = rng.rand(3, 80).astype(np.float32)
        v = rng.rand(3, 80) > 0.3
        return b, s, v, -0.25, 10
    if name.startswith("n"):              # N off or on the 64-box word
        n = int(name[1:])
        b = _random(rng, 4, n, spread=120.0)
        s = rng.rand(4, n).astype(np.float32)
        return b, s, rng.rand(4, n) > 0.2, 0.5, n
    if name.startswith("threshold"):
        thres = float(name.split("_")[1])
        b = threshold_pairs(thres)
        s = np.tile(np.array([[0.9, 0.8]], np.float32), (3, 1))
        return b, s, np.ones((3, 2), bool), thres, 2
    raise KeyError(name)


CASES = ["ties", "all_overlapping", "all_invalid", "n1", "n37", "n64",
         "n65", "n129", "n130", "n200", "disjoint", "degenerate",
         "negative_threshold", "threshold_0.7", "threshold_0.5",
         "threshold_0.3"]


# the paths' own NMS shapes [groups..., N]: the proposals at test and in
# training (image, level), the predictions (image, class; ActEV's 15
# classes at 2R), EfficientDet's (image, class; 90 classes at 2R) and the
# small-object heads' (image, SO class)
PATH_SHAPES = {"proposals_test": (8, 5, 1000), "proposals_train": (2, 5, 2000),
               "predictions": (8, 15, 200), "effdet": (8, 90, 200),
               "small_objects": (8, 3, 1000)}


def path_case(shape, seed=0, spread=1920.0):
    """Score-sorted boxes [*shape, 4] float32 in a 1920x1080 frame,
    clustered as detections and proposals are (a box size a cluster, each
    box's centre and size jittered by ~10% of it, eight boxes a cluster on
    average), and valid [*shape] with ~20% invalid: (boxes, valid)."""
    rng = np.random.RandomState(seed)
    n = shape[-1]
    k = max(1, n // 8)
    centres = rng.uniform([0, 0], [spread, spread * 9 / 16],
                          shape[:-1] + (k, 2))
    sizes = np.exp(rng.uniform(np.log(8), np.log(400),
                               shape[:-1] + (k, 2)))
    pick = rng.randint(0, k, shape)[..., None]
    wh = np.take_along_axis(sizes, pick, -2) * np.exp(
        rng.normal(0, 0.1, shape + (2,)))
    c = np.take_along_axis(centres, pick, -2) + rng.normal(
        0, 0.1, shape + (2,)) * wh
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    return boxes, rng.rand(*shape) > 0.2
