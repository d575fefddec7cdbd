"""Camera models and ground-plane homographies (reference utils.py:59-146).

Cameras come as KRTD text files (K 3x3, R 3x3, T 3x1) or MEVA-style json
(column-major intrinsic/extrinsic). The cross-camera homography is the
standard plane-induced homography for the z=0 ground plane.
"""

from __future__ import annotations

import json

import numpy as np


def parse_camera_krtd(path: str):
    with open(path) as f:
        lines = f.readlines()
    k = np.array([lines[i].split() for i in range(3)], np.float64)
    r = np.array([lines[i].split() for i in range(4, 7)], np.float64)
    t = np.array(lines[8].split(), np.float64).reshape(3, 1)
    return r, t, k


def parse_camera_json(path: str):
    with open(path) as f:
        data = json.load(f)
    # column-major 3x3 intrinsic
    k = np.asarray(data["intrinsic"]["intrinsic_matrix"],
                   np.float64).reshape(3, 3).T
    ext = np.asarray(data["extrinsic"], np.float64)
    # column-major 4x4 extrinsic: rotation cols at 0,4,8; translation at 12
    r = np.stack([ext[0:3], ext[4:7], ext[8:11]], axis=1)
    t = ext[12:15].reshape(3, 1)
    return r, t, k


def parse_camera_file(path: str):
    if path.endswith("json"):
        return parse_camera_json(path)
    return parse_camera_krtd(path)


def compute_c1_to_c2_homography(c1_r, c1_t, c1_k, c2_r, c2_t, c2_k):
    """Plane-induced homography mapping image points of camera 1 to camera 2
    for the world z=0 plane (reference utils.py:128-146)."""
    normal = np.array([[0.0], [0.0], [1.0]])
    normal1 = c1_r @ normal
    origin1 = c1_t  # c1_r @ 0 + t
    d_inv = 1.0 / float(normal1.squeeze() @ origin1.squeeze())
    r_1to2 = c2_r @ c1_r.T
    t_1to2 = c2_r @ (-c1_r.T @ c1_t) + c2_t
    h = r_1to2 + d_inv * (t_1to2 @ normal1.T)
    h = c2_k @ h @ np.linalg.inv(c1_k)
    return h / h[2, 2]


def warp_points(points: np.ndarray, homography: np.ndarray) -> np.ndarray:
    """points [2, N] -> warped [2, N] (homogeneous divide)."""
    assert points.shape[0] == 2
    n = points.shape[1]
    pts = np.concatenate([points, np.ones((1, n))], axis=0)
    w = homography @ pts
    return np.stack([w[0] / w[2], w[1] / w[2]], axis=0)


def parse_meva_clip_name(clip_name: str):
    """'2018-03-11.16-40-08.16-45-08.school.G424' ->
    (date, end_hour, camera) (ref utils.py:182-185); used to group
    synchronized MEVA clips when building the camera-config json."""
    date, _start, end_time, _location, camera = clip_name.split(".")
    return date, end_time.split("-")[0], camera
