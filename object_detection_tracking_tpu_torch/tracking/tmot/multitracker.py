"""JDE multi-object tracker (reference tmot/multitracker.py).

Tracks carry EMA-smoothed appearance embeddings; association runs in three
stages per frame: (1) embedding distance fused with Mahalanobis motion over
tracked+lost tracks, (2) IOU over still-unmatched tracked tracks, (3) IOU
over unconfirmed (single-frame) tracks. Output boxes are the raw detection
boxes (cur_det_tlwh), not the Kalman means — the reference found those more
accurate for MOT output (multitracker.py:32, SURVEY.md §2.2).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..kalman import KalmanFilter
from . import matching


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class STrack:
    def __init__(self, tlwh, score: float, feat: np.ndarray,
                 buffer_size: int = 30, alpha: float = 0.9):
        self._tlwh = np.asarray(tlwh, np.float64)
        self.kalman_filter: Optional[KalmanFilter] = None
        self.mean = None
        self.covariance = None
        self.is_activated = False
        self.state = TrackState.New
        self.score = float(score)
        self.tracklet_len = 0
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0
        self.alpha = alpha
        self.smooth_feat: Optional[np.ndarray] = None
        self.curr_feat: Optional[np.ndarray] = None
        # whole-life mean appearance for offline tracklet linking
        # (deep_sort.utils.link_tracklets) — the EMA smooth_feat forgets
        # the pre-occlusion appearance with alpha=0.9 in ~10 frames
        self.feat_sum: Optional[np.ndarray] = None
        self.feat_n = 0
        self.update_features(np.asarray(feat, np.float64))
        self.cur_det_tlwh = np.asarray(tlwh, np.float64)
        self.cur_det_conf = float(score)

    @property
    def end_frame(self) -> int:
        return self.frame_id

    def update_features(self, feat: np.ndarray):
        feat = feat / max(np.linalg.norm(feat), 1e-12)
        self.curr_feat = feat
        self.feat_sum = feat.copy() if self.feat_sum is None \
            else self.feat_sum + feat
        self.feat_n += 1
        if self.smooth_feat is None:
            self.smooth_feat = feat
        else:
            self.smooth_feat = self.alpha * self.smooth_feat + \
                (1 - self.alpha) * feat
        self.smooth_feat /= max(np.linalg.norm(self.smooth_feat), 1e-12)

    @staticmethod
    def multi_predict(stracks: List["STrack"], kf: KalmanFilter):
        if not stracks:
            return
        means = np.asarray([st.mean.copy() for st in stracks])
        covs = np.asarray([st.covariance for st in stracks])
        for i, st in enumerate(stracks):
            if st.state != TrackState.Tracked:
                means[i][7] = 0  # zero height velocity for lost tracks
        means, covs = kf.multi_predict(means, covs)
        for st, m, c in zip(stracks, means, covs):
            st.mean, st.covariance = m, c

    def activate(self, kf: KalmanFilter, frame_id: int, next_id):
        self.kalman_filter = kf
        self.track_id = next_id()
        self.mean, self.covariance = kf.initiate(
            self.tlwh_to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track: "STrack", frame_id: int):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance,
            self.tlwh_to_xyah(new_track.tlwh))
        self.update_features(new_track.curr_feat)
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        self.cur_det_tlwh = new_track.cur_det_tlwh
        self.cur_det_conf = new_track.cur_det_conf

    def update(self, new_track: "STrack", frame_id: int,
               update_feature: bool = True):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance,
            self.tlwh_to_xyah(new_track.tlwh))
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        if update_feature:
            self.update_features(new_track.curr_feat)
        self.cur_det_tlwh = new_track.cur_det_tlwh
        self.cur_det_conf = new_track.cur_det_conf

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    @property
    def tlwh(self) -> np.ndarray:
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[2] *= ret[3]
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def tlbr(self) -> np.ndarray:
        ret = self.tlwh.copy()
        ret[2:] += ret[:2]
        return ret

    @staticmethod
    def tlwh_to_xyah(tlwh) -> np.ndarray:
        ret = np.asarray(tlwh, np.float64).copy()
        ret[:2] += ret[2:] / 2
        ret[2] /= ret[3]
        return ret

    def to_xyah(self) -> np.ndarray:
        return self.tlwh_to_xyah(self.tlwh)


def joint_stracks(a: List[STrack], b: List[STrack]) -> List[STrack]:
    seen = {t.track_id for t in a}
    return list(a) + [t for t in b if t.track_id not in seen]


def sub_stracks(a: List[STrack], b: List[STrack]) -> List[STrack]:
    drop = {t.track_id for t in b}
    return [t for t in a if t.track_id not in drop]


def remove_duplicate_stracks(a: List[STrack], b: List[STrack]):
    pdist = matching.iou_distance(a, b)
    dup_a, dup_b = set(), set()
    for p, q in zip(*np.where(pdist < 0.15)):
        if a[p].frame_id - a[p].start_frame > b[q].frame_id - b[q].start_frame:
            dup_b.add(q)
        else:
            dup_a.add(p)
    return ([t for i, t in enumerate(a) if i not in dup_a],
            [t for i, t in enumerate(b) if i not in dup_b])


class JDETracker:
    def __init__(self, conf_thres: float, track_max_second_lost: float = 4.0,
                 emb_max_dist: float = 0.7, iou_max_dist1: float = 0.8,
                 iou_max_dist2: float = 0.9, emb_smooth_alpha: float = 0.9,
                 frame_gap: float = 8.0, frame_rate: float = 30.0):
        self.det_thresh = conf_thres
        self.max_frame_lost = track_max_second_lost * frame_rate / frame_gap
        self.emb_max_dist = emb_max_dist
        self.iou_max_dist1 = iou_max_dist1
        self.iou_max_dist2 = iou_max_dist2
        self.emb_smooth_alpha = emb_smooth_alpha
        self.reset()

    def reset(self):
        self.tracked_stracks: List[STrack] = []
        self.lost_stracks: List[STrack] = []
        self.removed_stracks: List[STrack] = []
        self.frame_id = 0
        self._count = 0
        self.kalman_filter = KalmanFilter()

    def _next_id(self) -> int:
        self._count += 1
        return self._count

    def update(self, detections) -> List[STrack]:
        """detections: iterable of (tlwh, conf, feature). Returns active
        tracks for this frame."""
        self.frame_id += 1
        activated, refind, lost, removed = [], [], [], []

        dets = [STrack(tlwh, conf, np.asarray(f, np.float64),
                       alpha=self.emb_smooth_alpha)
                for tlwh, conf, f in detections]

        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]

        # --- stage 1: embedding + motion over tracked + lost
        pool = joint_stracks(tracked, self.lost_stracks)
        STrack.multi_predict(pool, self.kalman_filter)
        dists = matching.embedding_distance(pool, dets)
        dists = matching.fuse_motion(self.kalman_filter, dists, pool, dets)
        matches, u_track, u_det = matching.linear_assignment(
            dists, thresh=self.emb_max_dist)
        for it, idet in matches:
            track, det = pool[it], dets[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id)
                refind.append(track)

        # --- stage 2: IOU over remaining tracked
        dets = [dets[i] for i in u_det]
        r_tracked = [pool[i] for i in u_track
                     if pool[i].state == TrackState.Tracked]
        dists = matching.iou_distance(r_tracked, dets)
        matches, u_track, u_det = matching.linear_assignment(
            dists, thresh=self.iou_max_dist1)
        for it, idet in matches:
            track, det = r_tracked[it], dets[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id)
                refind.append(track)
        for it in u_track:
            track = r_tracked[it]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # --- stage 3: IOU over unconfirmed tracks
        dets = [dets[i] for i in u_det]
        dists = matching.iou_distance(unconfirmed, dets)
        matches, u_unconfirmed, u_det = matching.linear_assignment(
            dists, thresh=self.iou_max_dist2)
        for it, idet in matches:
            unconfirmed[it].update(dets[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for it in u_unconfirmed:
            track = unconfirmed[it]
            track.mark_removed()
            removed.append(track)

        # --- init new tracks
        for idet in u_det:
            det = dets[idet]
            if det.score < self.det_thresh:
                continue
            det.activate(self.kalman_filter, self.frame_id, self._next_id)
            activated.append(det)

        # --- expire lost tracks
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_frame_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [
            t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks,
                                        self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks,
                                        self.removed_stracks)
        self.removed_stracks.extend(removed)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks)

        return [t for t in self.tracked_stracks if t.is_activated]

    def feature_archive(self):
        """{track_id: whole-life mean appearance} over every track this
        tracker ever assigned an id (live, lost, and removed), for
        offline tracklet linking — same contract as
        deep_sort.Tracker.feature_archive."""
        out = {}
        for t in (self.tracked_stracks + self.lost_stracks
                  + self.removed_stracks):
            if t.track_id > 0 and t.feat_n > 0:
                out[t.track_id] = t.feat_sum / t.feat_n
        return out
