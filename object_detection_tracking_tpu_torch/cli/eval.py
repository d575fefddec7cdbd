"""Standalone detection evaluation CLI (reference eval.py).

Inputs: a frame list, per-frame gt ``.npz`` (keys ``boxes`` x1y1x2y2 and
``labels`` strings) and per-frame detection ``.json`` (the format our
obj_detect_tracking CLI writes). Prints per-class AP/AR at IOU 0.5 in the
same csv layout as the reference.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..class_ids import coco_obj_to_actev_obj
from ..evaluation import aggregate_eval, evaluate_coco_style, match_dt_gt

DEFAULT_EVAL_TARGET = [
    "Vehicle", "Person", "Construction_Barrier", "Construction_Vehicle",
    "Door", "Dumpster", "Prop", "Push_Pulled_Object", "Bike",
    "Parking_Meter", "Skateboard", "Prop_Overshoulder",
]


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("filelst")
    parser.add_argument("gtpath")
    parser.add_argument("outpath")
    parser.add_argument("--skip", type=int, default=1)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--conf_thres", type=float, default=None)
    parser.add_argument("--merge_prop", action="store_true")
    parser.add_argument("--is_coco_model", action="store_true")
    parser.add_argument("--not_coco_box", action="store_true",
                        help="detection json bboxes are x1y1x2y2")
    parser.add_argument("--skip_not_exist_out", action="store_true")
    parser.add_argument("--eval_target", default=None,
                        help="comma-separated class names")
    parser.add_argument("--scene", default=None,
                        help="only eval videos of this ActEV scene id "
                        "(parsed from VIRAT_S_<scene>... names, ref "
                        "eval.py:41-45,95-103)")
    parser.add_argument("--bupt_exp", action="store_true",
                        help="BUPT activity-as-object eval targets")
    parser.add_argument("--meva_exp", action="store_true",
                        help="MEVA activity-as-object eval targets")
    parser.add_argument("--coco_eval", action="store_true",
                        help="also print COCO-protocol mAP@[.5:.95] "
                        "(native, pycocotools-free)")
    return parser.parse_args(argv)


def _gather_dt_by_name(boxes, probs, names, eval_target, not_coco_box=False):
    out = {one: [] for one in eval_target}
    for box, prob, name in zip(boxes, probs, names):
        if name not in eval_target:
            continue
        box = list(box)
        if not_coco_box:
            box[2] -= box[0]
            box[3] -= box[1]
        out[name].append(([float(round(x, 2)) for x in box],
                          float(round(prob, 4))))
    return out


def _gather_gt_by_name(boxes, names, eval_target):
    out = {one: [] for one in eval_target}
    for box, name in zip(boxes, names):
        if name in eval_target:
            b = [float(round(float(x), 1)) for x in box]
            b[2] -= b[0]
            b[3] -= b[1]
            out[name].append(b)
    return out


def main(argv=None):
    args = get_args(argv)
    files = sorted(os.path.splitext(os.path.basename(l.strip()))[0]
                   for l in open(args.filelst) if l.strip())[::args.skip]
    if args.scene is not None:
        def get_scene(videoname):
            return videoname.split("_S_")[-1].split("_")[0][:4]
        kept = [f for f in files if get_scene(f) == args.scene]
        print("only eval scene %s, got %s/%s files"
              % (args.scene, len(kept), len(files)))
        files = kept

    eval_target = (args.eval_target.split(",") if args.eval_target
                   else (["Person", "Vehicle", "Bike"] if args.is_coco_model
                         else DEFAULT_EVAL_TARGET))
    if args.bupt_exp:
        from ..class_ids import targetAct2id_bupt
        eval_target = [c for c in targetAct2id_bupt if c != "BG"]
    elif args.meva_exp:
        from ..class_ids import targetAct2id_meva
        eval_target = [c for c in targetAct2id_meva if c != "BG"]
    if args.merge_prop and "Prop_plus_Push_Pulled_Object" not in eval_target:
        eval_target = eval_target + ["Prop_plus_Push_Pulled_Object"]
    eval_target = {one: 1 for one in eval_target}
    e = {one: {} for one in eval_target}
    coco_images = []
    count_no_out = 0

    for filename in files:
        gtfile = os.path.join(args.gtpath, f"{filename}.npz")
        outfile = os.path.join(args.outpath, f"{filename}.json")
        if not os.path.exists(gtfile):
            continue
        anno = dict(np.load(gtfile, allow_pickle=True))
        if not os.path.exists(outfile):
            count_no_out += 1
            if args.skip_not_exist_out:
                continue
            out = []
        else:
            with open(outfile) as f:
                out = json.load(f)
        if args.conf_thres is not None:
            out = [o for o in out if o["score"] >= args.conf_thres]
        if args.merge_prop:
            for o in out:
                if o["cat_name"] in ("Push_Pulled_Object", "Prop"):
                    o["cat_name"] = "Prop_plus_Push_Pulled_Object"
        if args.is_coco_model:
            new = []
            for o in out:
                if o["cat_name"] in coco_obj_to_actev_obj:
                    o["cat_name"] = coco_obj_to_actev_obj[o["cat_name"]]
                    new.append(o)
            out = new
        if args.limit is not None:
            out.sort(key=lambda o: -o["score"])
            out = out[:args.limit]

        dt = _gather_dt_by_name([o["bbox"] for o in out],
                                [o["score"] for o in out],
                                [o["cat_name"] for o in out],
                                eval_target, args.not_coco_box)
        labels = [o.decode() if isinstance(o, bytes) else str(o)
                  for o in anno["labels"]]
        gt = _gather_gt_by_name(anno["boxes"], labels, eval_target)
        match_dt_gt(e, filename, dt, gt, eval_target)
        if args.coco_eval:
            coco_images.append((dt, gt))

    print("%s/%s out file not exists" % (count_no_out, len(files)))
    aps, ars = aggregate_eval(e, maxDet=100)
    classes = sorted(aps.keys())
    print(",".join(["metric"] + classes))
    print(",".join(["AP"] + ["%.6f" % aps[c] for c in classes]))
    print(",".join(["AR"] + ["%.6f" % ars[c] for c in classes]))
    mean_ap = sum(aps.values()) / len(aps) if aps else 0.0
    mean_ar = sum(ars.values()) / len(ars) if ars else 0.0
    print("mean AP: %.6f, mean AR: %.6f" % (mean_ap, mean_ar))
    if args.coco_eval:
        ap_pc, mAP, mAP50 = evaluate_coco_style(coco_images, eval_target)
        print("COCO-style mAP@[.5:.95]: %.6f  mAP50: %.6f" % (mAP, mAP50))
        print(",".join(["cocoAP"] + ["%.6f" % ap_pc[c] for c in classes]))


if __name__ == "__main__":
    main()
