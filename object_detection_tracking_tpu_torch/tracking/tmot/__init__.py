"""TMOT/JDE tracker: EMA-smoothed embeddings, 3-stage association
(embedding+motion fusion -> IOU -> unconfirmed-IOU), lost-track buffer.

Behavioral parity with the reference tmot/ package (multitracker.py,
matching.py), using the shared Kalman filter and the native lapjv solver
with cost-limit extension (tracking/assignment.py) instead of the
third-party lap/cython_bbox/numba stack.
"""

from .multitracker import JDETracker, STrack  # noqa: F401
