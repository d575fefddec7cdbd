"""Source-tree fingerprint for the port's quality artifacts.

Each ``TORCH_QUALITY_*.json`` records the hash of the port's trees that
produced it (the port of object_detection_tracking_tpu/utils/source_hash.py,
over the port's own files, with its kernels' CUDA and C++ sources and
their build, the in-memory scene and video renderer, the train loop, the
mask paste, the video path and trackers, and the proofs themselves). A reader compares it with ``quality_tree_hash()``
of the tree at hand to see whether the artifact is fresh.
"""

from __future__ import annotations

import hashlib
import os

# every tree whose behavior the quality proofs measure: the models, their
# kernels and how they are built, the train loop and its schedule, the
# init, the scenes, clips and batches, the eval and the mask paste, the
# video path (process_video) and its trackers, and the proofs
QUALITY_TREES = ("models", "train", "ops", "tracking", "runtime", "csrc",
                 "native.py", "config.py", "class_ids.py", "params.py",
                 "evaluation.py", "evaluation_mot.py", "data/synthetic.py",
                 "data/training.py", "data/synthetic_np.py",
                 "utils/masks.py", "cli/main.py", "cli/quality_proof.py",
                 "cli/obj_detect_tracking.py", "cli/track_quality_proof.py")


def quality_tree_hash(package_root: str | None = None) -> str:
    """sha256 over (relpath, bytes) of every .py/.cpp/.cu file under
    QUALITY_TREES, sorted; stable across checkouts and platforms."""
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    h = hashlib.sha256()
    for entry in QUALITY_TREES:
        path = os.path.join(package_root, entry)
        files = []
        if os.path.isfile(path):
            files = [path]
        else:
            for dirpath, _, names in os.walk(path):
                files += [os.path.join(dirpath, n) for n in names
                          if n.endswith((".py", ".cpp", ".cu"))]
        for f in sorted(files):
            rel = os.path.relpath(f, package_root)
            h.update(rel.encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]
