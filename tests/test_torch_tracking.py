"""The port's host tracking code against the JAX package's: identical
detection streams must give identical Deep SORT tracks (ids and boxes,
exactly: both are the same numpy code), and the Kalman filter, the
assignment solver and the track post-processing must agree exactly."""

import numpy as np
import pytest

pytest.importorskip("jax")

from object_detection_tracking_tpu.tracking import assignment as jassign  # noqa: E402
from object_detection_tracking_tpu.tracking import deep_sort as jds  # noqa: E402
from object_detection_tracking_tpu.tracking.deep_sort.nn_matching import (  # noqa: E402
    NearestNeighborDistanceMetric as JMetric)
from object_detection_tracking_tpu.tracking.kalman import (  # noqa: E402
    KalmanFilter as JKalman)
from object_detection_tracking_tpu_torch.tracking import assignment  # noqa: E402
from object_detection_tracking_tpu_torch.tracking import deep_sort as ds  # noqa: E402
from object_detection_tracking_tpu_torch.tracking.deep_sort.nn_matching import (  # noqa: E402
    NearestNeighborDistanceMetric as Metric)
from object_detection_tracking_tpu_torch.tracking.kalman import KalmanFilter  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401

NAMES = {1: "person", 2: "car", 3: "bicycle"}
TO_ACTEV = {"person": "Person", "car": "Vehicle", "bicycle": "Bike"}


def detection_stream(seed=0, n_frames=40, n_obj=6, r=12, dim=16):
    """Per frame: detector-style padded outputs (boxes xyxy, labels, probs,
    embeddings, valid) of objects moving with noise, some missed frames,
    crossings and clutter."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 300, (n_obj, 2))
    vel = rng.uniform(-6, 6, (n_obj, 2))
    size = rng.uniform(20, 80, (n_obj, 2))
    emb = rng.randn(n_obj, dim)
    labels = np.arange(n_obj) % 3 + 1            # two of each class
    frames = []
    for t in range(n_frames):
        boxes = np.zeros((r, 4), np.float32)
        lab = np.zeros(r, np.int32)
        prob = np.zeros(r, np.float32)
        feat = np.zeros((r, dim), np.float32)
        valid = np.zeros(r, bool)
        k = 0
        for i in range(n_obj):
            if rng.rand() < 0.15:
                continue                              # missed detection
            p = pos[i] + vel[i] * t + rng.randn(2)
            boxes[k] = [p[0], p[1], p[0] + size[i, 0], p[1] + size[i, 1]]
            lab[k], prob[k] = labels[i], rng.uniform(0.5, 1.0)
            feat[k] = emb[i] + 0.1 * rng.randn(dim)
            valid[k] = True
            k += 1
        for _ in range(rng.randint(0, 3)):            # clutter
            p = rng.uniform(0, 300, 2)
            boxes[k] = [p[0], p[1], p[0] + 30, p[1] + 30]
            lab[k], prob[k] = rng.randint(1, 4), rng.uniform(0.3, 1.0)
            feat[k] = rng.randn(dim)
            valid[k] = True
            k += 1
        frames.append((boxes, lab, prob, feat, valid))
    return frames


def run_tracker(pkg, metric_cls, frames, obj, scale=1.0, n_init=1):
    tracker = pkg.Tracker(metric_cls("cosine", 0.5, 5), n_init=n_init)
    rows = []
    for t, (boxes, lab, prob, feat, valid) in enumerate(frames):
        dets = pkg.create_obj_infos(boxes, lab, prob, feat, valid, NAMES, obj,
                                    scale=scale, min_confidence=0.6,
                                    coco_to_actev=TO_ACTEV)
        dets = pkg.det_level_nms(dets, 0.85)
        tracker.predict()
        tracker.update(dets)
        for trk in tracker.tracks:
            if trk.is_confirmed() and trk.time_since_update <= 1:
                rows.append([t, trk.track_id] + list(trk.to_tlwh()))
    return np.asarray(rows, np.float64).reshape(-1, 6), tracker


@pytest.mark.parametrize("seed,obj,n_init", [(0, "Person", 1),
                                             (1, "Vehicle", 1),
                                             (2, "Bike", 3)])
def test_identical_streams_give_identical_tracks(seed, obj, n_init):
    frames = detection_stream(seed)
    ref, jt = run_tracker(jds, JMetric, frames, obj, 0.8, n_init)
    got, tt = run_tracker(ds, Metric, frames, obj, 0.8, n_init)
    assert len(ref) > 0
    np.testing.assert_array_equal(got, ref)
    post = (lambda m, d: m.filter_short_objs(m.linear_inter_bbox(d, 2)))
    np.testing.assert_array_equal(post(ds, got.astype(np.float32)),
                                  post(jds, ref.astype(np.float32)))
    ja, ta = jt.feature_archive(), tt.feature_archive()
    assert sorted(ja) == sorted(ta)
    linked_ref = jds.link_tracklets(ref.astype(np.float32), ja, frame_gap=2)
    linked = ds.link_tracklets(got.astype(np.float32), ta, frame_gap=2)
    np.testing.assert_array_equal(linked, linked_ref)


def test_kalman_filter_matches():
    rng = np.random.RandomState(3)
    jkf, kf = JKalman(), KalmanFilter()
    meas = np.array([100.0, 50.0, 0.5, 80.0])
    jm, jc = jkf.initiate(meas)
    m, c = kf.initiate(meas)
    for _ in range(10):
        jm, jc = jkf.predict(jm, jc)
        m, c = kf.predict(m, c)
        z = meas + rng.randn(4) * [2, 2, 0.01, 2]
        jm, jc = jkf.update(jm, jc, z)
        m, c = kf.update(m, c, z)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(c, jc)
    zs = meas + rng.randn(7, 4)
    np.testing.assert_array_equal(kf.gating_distance(m, c, zs),
                                  jkf.gating_distance(jm, jc, zs))
    means = np.stack([m, jm + 1])
    covs = np.stack([c, jc])
    np.testing.assert_array_equal(kf.multi_predict(means, covs)[0],
                                  jkf.multi_predict(means, covs)[0])
    np.testing.assert_array_equal(kf.gating_distance_multi(means, covs, zs),
                                  jkf.gating_distance_multi(means, covs, zs))


@pytest.mark.parametrize("n,m", [(3, 5), (12, 12), (20, 20)])
def test_assignment_matches(n, m):
    rng = np.random.RandomState(n)
    cost = rng.rand(n, m)
    r1, c1 = assignment.linear_sum_assignment(cost)
    r2, c2 = jassign.linear_sum_assignment(cost)
    assert cost[r1, c1].sum() == pytest.approx(cost[r2, c2].sum(), abs=1e-12)
    np.testing.assert_array_equal(np.sort(r1), np.sort(r2))
