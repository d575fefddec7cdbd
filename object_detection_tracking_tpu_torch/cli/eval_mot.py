"""Score MOT-format track files against ground truth (CLEAR-MOT + IDF1).

The reference emits MOT rows (obj_detect_tracking.py:795-809) and defers
scoring to external challenge tooling (motmetrics / ActEV submission);
this CLI scores natively with evaluation_mot so the whole loop closes
inside the framework.

Inputs are MOT txt files (``frame,id,x,y,w,h,conf,...``), either single
files or the tracking CLIs' output layout ``dir/<video>/<class>/<video>.txt``.

Usage:
  # single pair of files
  python -m object_detection_tracking_tpu_torch.cli.eval_mot gt.txt hyp.txt
  # tracking-dir layout, per-class + overall
  python -m object_detection_tracking_tpu_torch.cli.eval_mot gt_dir hyp_dir \
      --videonamelst videos.lst --classes Person,Vehicle
"""

from __future__ import annotations

import argparse
import json
import os


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("gt", help="gt MOT txt, or dir of <video>/<class>/*.txt")
    p.add_argument("hyp", help="hypothesis MOT txt or dir (same layout)")
    p.add_argument("--videonamelst", default=None,
                   help="file of video names (dir mode)")
    p.add_argument("--classes", default=None,
                   help="comma list of class subdirs (dir mode)")
    p.add_argument("--iou_thres", type=float, default=0.5)
    p.add_argument("--out_json", default=None)
    return p.parse_args(argv)


def _accumulate(totals, m):
    for k in ("fn", "fp", "idsw", "n_gt", "idtp", "idfp", "idfn"):
        totals[k] += m[k]
    totals["iou_sum"] += m["motp"] * m["n_matches"]
    totals["n_matches"] += m["n_matches"]


def _finalize(totals):
    mota = 1.0 - (totals["fn"] + totals["fp"] + totals["idsw"]) / \
        max(totals["n_gt"], 1)
    idf1 = 2.0 * totals["idtp"] / \
        max(2 * totals["idtp"] + totals["idfp"] + totals["idfn"], 1)
    motp = totals["iou_sum"] / max(totals["n_matches"], 1)
    return {"mota": round(mota, 4), "idf1": round(idf1, 4),
            "motp": round(motp, 4), "idsw": totals["idsw"],
            "fn": totals["fn"], "fp": totals["fp"], "n_gt": totals["n_gt"]}


def main(argv=None):
    from ..evaluation_mot import evaluate_tracks, load_mot_txt

    args = get_args(argv)
    pairs = []  # (label, gt_path, hyp_path)
    if os.path.isdir(args.gt):
        assert args.videonamelst and args.classes, \
            "dir mode needs --videonamelst and --classes"
        videos = [os.path.splitext(os.path.basename(l.strip()))[0]
                  for l in open(args.videonamelst) if l.strip()]
        classes = args.classes.split(",")
        for v in videos:
            for c in classes:
                pairs.append((f"{v}/{c}",
                              os.path.join(args.gt, v, c, f"{v}.txt"),
                              os.path.join(args.hyp, v, c, f"{v}.txt")))
    else:
        pairs.append(("all", args.gt, args.hyp))

    totals = dict(fn=0, fp=0, idsw=0, n_gt=0, idtp=0, idfp=0, idfn=0,
                  iou_sum=0.0, n_matches=0)
    per = {}
    for label, gt_path, hyp_path in pairs:
        gt = load_mot_txt(gt_path) if os.path.exists(gt_path) else {}
        hyp = load_mot_txt(hyp_path) if os.path.exists(hyp_path) else {}
        m = evaluate_tracks(gt, hyp, args.iou_thres)
        per[label] = {k: round(float(v), 4) for k, v in m.items()}
        _accumulate(totals, m)

    out = _finalize(totals)
    if len(pairs) > 1:
        out["per_item"] = per
    print(json.dumps(out, indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
