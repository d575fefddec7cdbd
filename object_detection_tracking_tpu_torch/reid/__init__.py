"""Track-level ReID post-processing.

  * single_video: merge broken tracklets within one video by appearance
    (reference single_video_reid.py).
  * multi_video: assign global ids across synchronized cameras using
    ground-plane homography gating + appearance matching (reference
    multi_video_reid.py).
  * cameras: KRTD/json camera parsing and plane-induced homographies
    (reference utils.py:59-146).
"""

from .cameras import (compute_c1_to_c2_homography, parse_camera_file,  # noqa
                      warp_points)
from .single_video import (find_candidate_pairs, load_tracks,  # noqa: F401
                           merge_candidates, relink_video_tracks,
                           save_tracks)
from .multi_video import (compute_feature_dist,  # noqa: F401
                          compute_spatial_dist, link_across_cameras)
