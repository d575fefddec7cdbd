"""The port's TMOT/JDE tracker against the JAX package's: the cost-capped
rectangular assignment (``lapjv_extended``) on random costs with
unmatchable entries and ties, and ``JDETracker`` on seeded detection
streams with births, deaths, occlusion gaps longer than the lost buffer,
crossings and low-confidence detections, at frame gaps 1 and 8. Both are
the same numpy code over the same lapjv solver, so every output is
equal exactly."""

import numpy as np
import pytest

pytest.importorskip("jax")

from object_detection_tracking_tpu.tracking import assignment as jassign  # noqa: E402
from object_detection_tracking_tpu.tracking import tmot as jtmot  # noqa: E402
from object_detection_tracking_tpu_torch.tracking import assignment  # noqa: E402
from object_detection_tracking_tpu_torch.tracking import tmot  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401


def random_costs(seed):
    """Rectangular costs of every size from 0 to 12 a side: uniform,
    quantised to a few levels (ties), and with inf (gated) entries."""
    rng = np.random.RandomState(seed)
    for n in range(13):
        for m in range(13):
            cost = rng.rand(n, m)
            if (n + m) % 3 == 1:
                cost = np.round(cost * 4) / 4            # ties
            if (n + m) % 2:
                cost[rng.rand(n, m) < 0.3] = np.inf     # gated pairs
            yield cost, float(rng.choice([0.3, 0.7, 0.9, 1.0]))


@pytest.mark.parametrize("seed", [0, 1])
def test_lapjv_extended_equals_jax(seed):
    matched = 0
    for cost, limit in random_costs(seed):
        x, y = assignment.lapjv_extended(cost, cost_limit=limit)
        jx, jy = jassign.lapjv_extended(cost, cost_limit=limit)
        assert x.dtype == jx.dtype and y.dtype == jy.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.shape == (cost.shape[0],) and y.shape == (cost.shape[1],)
        rows = np.flatnonzero(x >= 0)
        assert (cost[rows, x[rows]] < limit).all()
        matched += len(rows)
    assert matched > 100


def detection_stream(seed, n_frames=60, dim=32):
    """Per frame, the (tlwh, conf, feature) list the CLI feeds JDETracker:
    objects born and dying at random frames, some occluded for 20 frames
    (longer than a 15-frame lost buffer) or briefly, pairs crossing each
    other, detection noise, embeddings near each object's own, a few
    detections below the confidence threshold and clutter."""
    rng = np.random.RandomState(seed)
    n_obj = 10
    born = rng.randint(0, 30, n_obj)
    dies = born + rng.randint(15, 60, n_obj)
    start = rng.uniform(20, 400, (n_obj, 2))
    vel = rng.uniform(-5, 5, (n_obj, 2))
    # objects 0 and 1 cross: same row, opposite directions
    start[0], vel[0] = (40, 200), (6, 0)
    start[1], vel[1] = (400, 205), (-6, 0)
    born[:2], dies[:2] = 0, n_frames
    size = rng.uniform(20, 70, (n_obj, 2))
    emb = rng.randn(n_obj, dim)
    hidden = {2: range(10, 30), 3: range(20, 24), 4: range(35, 38)}
    born[2:5], dies[2:5] = 0, n_frames
    frames = []
    for t in range(n_frames):
        dets = []
        for i in range(n_obj):
            if not born[i] <= t < dies[i] or t in hidden.get(i, ()):
                continue
            p = start[i] + vel[i] * t + rng.randn(2)
            conf = rng.uniform(0.4, 1.0)
            dets.append(((p[0], p[1], size[i, 0], size[i, 1]), conf,
                         (emb[i] + 0.2 * rng.randn(dim)).astype(np.float32)))
        for _ in range(rng.randint(0, 3)):            # clutter
            p = rng.uniform(0, 450, 2)
            dets.append(((p[0], p[1], 30.0, 30.0), rng.uniform(0.3, 1.0),
                         rng.randn(dim).astype(np.float32)))
        order = rng.permutation(len(dets))
        frames.append([dets[k] for k in order])
    return frames


def run_jde(pkg, frames, frame_gap, max_second_lost):
    tracker = pkg.JDETracker(conf_thres=0.6,
                             track_max_second_lost=max_second_lost,
                             emb_max_dist=0.7, frame_gap=frame_gap)
    out = []
    for dets in frames:
        out.append([(t.track_id, t.cur_det_tlwh.copy(), t.state)
                    for t in tracker.update(dets)])
    return out, tracker


# frame gap 1 with 0.5 s lost buffers and gap 8 with the CLI's 4 s both
# drop a track after 15 frames, so the 20-frame occlusion outlasts it
@pytest.mark.parametrize("seed,frame_gap,max_second_lost",
                         [(0, 1, 0.5), (1, 8, 4.0), (2, 1, 4.0)])
def test_jde_tracker_equals_jax(seed, frame_gap, max_second_lost):
    frames = detection_stream(seed)
    ref, jt = run_jde(jtmot, frames, frame_gap, max_second_lost)
    got, tt = run_jde(tmot, frames, frame_gap, max_second_lost)
    assert len(got) == len(ref) == 60
    for t, (g, r) in enumerate(zip(got, ref)):
        assert [x[0] for x in g] == [x[0] for x in r], t
        assert [x[2] for x in g] == [x[2] for x in r], t
        for (_, gb, _), (_, rb, _) in zip(g, r):
            np.testing.assert_array_equal(gb, rb)
    ids = {x[0] for frame in got for x in frame}
    assert len(ids) >= 10
    if max_second_lost == 0.5 or frame_gap == 8:
        # the occluded object comes back as a new id: its track expired
        assert len(tt.removed_stracks) > 0
    ja, ta = jt.feature_archive(), tt.feature_archive()
    assert sorted(ta) == sorted(ja) and len(ta) >= len(ids)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k])
    assert [t.track_id for t in tt.lost_stracks] == \
        [t.track_id for t in jt.lost_stracks]


def test_matching_costs_equal_jax():
    """The three association costs on tracks after a few updates."""
    from object_detection_tracking_tpu.tracking.tmot import matching as jm
    from object_detection_tracking_tpu_torch.tracking.tmot import matching
    frames = detection_stream(3)
    _, jt = run_jde(jtmot, frames[:12], 1, 4.0)
    _, tt = run_jde(tmot, frames[:12], 1, 4.0)
    jd = [jtmot.STrack(*d) for d in frames[12]]
    td = [tmot.STrack(*d) for d in frames[12]]
    jp, tp = jt.tracked_stracks, tt.tracked_stracks
    assert len(tp) > 3
    np.testing.assert_array_equal(matching.iou_distance(tp, td),
                                  jm.iou_distance(jp, jd))
    emb = matching.embedding_distance(tp, td)
    np.testing.assert_array_equal(emb, jm.embedding_distance(jp, jd))
    fused = matching.fuse_motion(tt.kalman_filter, emb.copy(), tp, td)
    np.testing.assert_array_equal(
        fused, jm.fuse_motion(jt.kalman_filter, emb.copy(), jp, jd))
    assert np.isinf(fused).any() and np.isfinite(fused).any()
