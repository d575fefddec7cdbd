"""Query-vs-gallery ReID distance check (port of
object_detection_tracking_tpu/cli/reid_query.py:22-69; reference
test_reid.py:1-53).

Loads one ReID extractor (person model by name, or the vehicle
ResNet-101), embeds [query] + sorted(glob(prefix + "*")) images, and
prints the full NxN distance matrix — the reference's quick sanity
harness for converted checkpoints.

Usage:
  python -m object_detection_tracking_tpu_torch.cli.reid_query query.jpg \
      gallery_prefix --person_reid_model osnet.pth \
      [--p_model_name osnet_x1_0] [--metric euclidean] [--device cpu]

The same flags as the JAX CLI, plus ``--device`` (default cuda; with no
GPU it raises unless ``--device cpu`` is given). The images are read with
cv2, as the JAX CLI reads them.
"""

from __future__ import annotations

import argparse
from glob import glob

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("query_img")
    p.add_argument("test_img_prefix")
    p.add_argument("--vehicle_reid_model", default=None,
                   help=".pth for the vehicle ResNet-101 extractor")
    p.add_argument("--person_reid_model", default=None,
                   help=".pth for the person extractor (--p_model_name)")
    p.add_argument("--p_model_name", default="osnet_x1_0")
    p.add_argument("--metric", default="euclidean",
                   choices=["euclidean", "cosine"])
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:N | cpu (no silent CPU fallback)")
    return p.parse_args(argv)


def main(argv=None):
    import cv2

    from ..models.reid.extractor import compute_distance_matrix
    from .single_video_reid import extractor as build_extractor

    args = get_args(argv)
    if args.person_reid_model is not None:
        extractor = build_extractor(args.p_model_name,
                                    args.person_reid_model, args.device)
    elif args.vehicle_reid_model is not None:
        extractor = build_extractor("resnet101", args.vehicle_reid_model,
                                    args.device)
    else:
        raise SystemExit("Please provide a model!")

    test_imgs = sorted(glob(args.test_img_prefix + "*"))
    assert test_imgs, f"no gallery images match {args.test_img_prefix}*"
    img_list = [args.query_img] + test_imgs
    print(img_list)
    crops = []
    for path in img_list:
        im = cv2.imread(path)
        assert im is not None, f"unreadable image {path}"
        crops.append(im)
    features = extractor(crops)
    print(features.shape)
    distmat = compute_distance_matrix(features, features, args.metric)
    np.set_printoptions(suppress=True, precision=3)
    print(distmat)
    return distmat


if __name__ == "__main__":
    main()
