"""Drawing helpers (reference utils.py:727-790, viz.py:143-376): the port's
copy of object_detection_tracking_tpu/utils/viz.py.

Host-side cv2 drawing for --visualize outputs and the track/json viewers;
cv2 is imported if present.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# distinct color palette (reference PALETTE_HEX, utils.py:850)
PALETTE_HEX = [
    "#FFFF00", "#1CE6FF", "#FF34FF", "#FF4A46", "#008941", "#006FA6",
    "#A30059", "#FFDBE5", "#7A4900", "#0000A6", "#63FFAC", "#B79762",
    "#004D43", "#8FB0FF", "#997D87", "#5A0007", "#809693", "#FEFFE6",
    "#1B4400", "#4FC601", "#3B5DFF", "#4A3B53", "#FF2F80", "#61615A",
    "#BA0900", "#6B7900", "#00C2A0", "#FFAA92", "#FF90C9", "#B903AA",
]


def hex_to_bgr(h: str):
    h = h.lstrip("#")
    r, g, b = (int(h[i:i + 2], 16) for i in (0, 2, 4))
    return (b, g, r)


PALETTE_BGR = [hex_to_bgr(h) for h in PALETTE_HEX]


def color_for_id(track_id: int):
    return PALETTE_BGR[int(track_id) % len(PALETTE_BGR)]


def draw_boxes(im: np.ndarray, boxes: Sequence, labels: Optional[List[str]]
               = None, colors=None, font_scale: float = 0.5,
               thickness: int = 2) -> np.ndarray:
    """boxes x1y1x2y2; returns a drawn copy (utils.py:727)."""
    im = im.copy()
    for i, box in enumerate(boxes):
        x1, y1, x2, y2 = [int(round(float(v))) for v in box]
        color = (colors[i] if colors is not None else (255, 0, 0))
        if isinstance(color, np.ndarray):
            color = tuple(int(c) for c in color)
        cv2.rectangle(im, (x1, y1), (x2, y2), color, thickness)
        if labels is not None:
            cv2.putText(im, labels[i], (x1, max(y1 - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, font_scale, color, 1,
                        cv2.LINE_AA)
    return im


def draw_mask(im: np.ndarray, mask: np.ndarray, color=None,
              alpha: float = 0.5, show_border: bool = True,
              border_thick: int = 1) -> np.ndarray:
    """Alpha-blend a binary full-frame mask onto a BGR image and trace its
    contour in white (reference viz.py:338-361 draw_mask)."""
    if color is None:
        color = PALETTE_BGR[0]
    on = mask > 0
    im = im.astype(np.float32, copy=True)
    im[on] = im[on] * (1.0 - alpha) + np.asarray(color, np.float32) * alpha
    im = im.astype(np.uint8)
    if show_border:
        contours, _ = cv2.findContours(
            np.ascontiguousarray(mask, np.uint8), cv2.RETR_CCOMP,
            cv2.CHAIN_APPROX_NONE)
        cv2.drawContours(im, contours, -1, (255, 255, 255), border_thick,
                         lineType=cv2.LINE_AA)
    return im


# COCO 17-keypoint order + skeleton (reference viz.py:215-274)
COCO_KEYPOINTS = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]
_K = COCO_KEYPOINTS.index
KP_LINES = [
    (_K("left_eye"), _K("right_eye")), (_K("left_eye"), _K("nose")),
    (_K("right_eye"), _K("nose")), (_K("right_eye"), _K("right_ear")),
    (_K("left_eye"), _K("left_ear")),
    (_K("right_shoulder"), _K("right_elbow")),
    (_K("right_elbow"), _K("right_wrist")),
    (_K("left_shoulder"), _K("left_elbow")),
    (_K("left_elbow"), _K("left_wrist")),
    (_K("right_hip"), _K("right_knee")),
    (_K("right_knee"), _K("right_ankle")),
    (_K("left_hip"), _K("left_knee")),
    (_K("left_knee"), _K("left_ankle")),
    (_K("right_shoulder"), _K("left_shoulder")),
    (_K("right_hip"), _K("left_hip")),
]


def vis_keypoints(im: np.ndarray, kps: np.ndarray, kp_thresh: float = 2.0,
                  alpha: float = 0.7) -> np.ndarray:
    """Draw a COCO-17 skeleton (reference viz.py:276-336 vis_keypoints).

    kps: [3+, 17] rows (x, y, score[, ...]); bones/joints drawn where both
    endpoint scores exceed kp_thresh, then alpha-blended onto the frame.
    Adds the mid-shoulder->nose and mid-shoulder->mid-hip spine bones the
    reference draws first."""
    kps = np.asarray(kps, np.float32)
    overlay = im.copy()
    colors = [color_for_id(i) for i in range(len(KP_LINES) + 2)]
    mid_sh = (kps[:2, _K("right_shoulder")] + kps[:2, _K("left_shoulder")]) / 2
    sc_sh = min(kps[2, _K("right_shoulder")], kps[2, _K("left_shoulder")])
    mid_hip = (kps[:2, _K("right_hip")] + kps[:2, _K("left_hip")]) / 2
    sc_hip = min(kps[2, _K("right_hip")], kps[2, _K("left_hip")])
    if sc_sh > kp_thresh and kps[2, _K("nose")] > kp_thresh:
        cv2.line(overlay, tuple(mid_sh.astype(int)),
                 tuple(kps[:2, _K("nose")].astype(int)),
                 colors[len(KP_LINES)], 2, cv2.LINE_AA)
    if sc_sh > kp_thresh and sc_hip > kp_thresh:
        cv2.line(overlay, tuple(mid_sh.astype(int)),
                 tuple(mid_hip.astype(int)),
                 colors[len(KP_LINES) + 1], 2, cv2.LINE_AA)
    for li, (i1, i2) in enumerate(KP_LINES):
        p1 = (int(kps[0, i1]), int(kps[1, i1]))
        p2 = (int(kps[0, i2]), int(kps[1, i2]))
        if kps[2, i1] > kp_thresh and kps[2, i2] > kp_thresh:
            cv2.line(overlay, p1, p2, colors[li], 2, cv2.LINE_AA)
        if kps[2, i1] > kp_thresh:
            cv2.circle(overlay, p1, 3, colors[li], -1, cv2.LINE_AA)
        if kps[2, i2] > kp_thresh:
            cv2.circle(overlay, p2, 3, colors[li], -1, cv2.LINE_AA)
    return cv2.addWeighted(im, 1.0 - alpha, overlay, alpha, 0)


def draw_tracks(im: np.ndarray, rows: np.ndarray,
                thickness: int = 2) -> np.ndarray:
    """rows: [N, >=6] (frame, id, x, y, w, h) already filtered to one
    frame; per-id stable colors (vis_tracks.py)."""
    boxes = []
    labels = []
    colors = []
    for r in rows:
        tid = int(r[1])
        x, y, w, h = r[2:6]
        boxes.append([x, y, x + w, y + h])
        labels.append(f"#{tid}")
        colors.append(color_for_id(tid))
    return draw_boxes(im, boxes, labels, colors, thickness=thickness)
