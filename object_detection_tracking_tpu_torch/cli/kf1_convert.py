"""Convert MEVA/KF1 Kitware YAML annotations to the ActEV Scorer official
JSON format (reference diva_io/annotation/converter.py:54-63).

Writes ``reference.json`` and ``file-index.json`` into the output dir.
"""

from __future__ import annotations

import argparse

from ..data.kf1 import convert_kf1


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("annotation_dir",
                   help="MEVA annotation repo root "
                        "(<date>/<hour>/<clip>.{activities,geom,types}.yml)")
    p.add_argument("output_dir")
    p.add_argument("--video_lst", default=None,
                   help="file of clip names, one per line (default: the "
                        "repo's list-of-annotated-meva-clips.txt)")
    p.add_argument("--framerate", type=float, default=30.0)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    video_list = None
    if args.video_lst:
        with open(args.video_lst) as f:
            video_list = [line.strip() for line in f if line.strip()]
    written = convert_kf1(args.annotation_dir, args.output_dir,
                          video_list=video_list, framerate=args.framerate)
    for name, path in written.items():
        print(f"{name}: {path}")


if __name__ == "__main__":
    main()
