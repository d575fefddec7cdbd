"""Image-list object detection CLI (port of
object_detection_tracking_tpu/cli/obj_detect_imgs.py; the reference's
obj_detect_imgs.py / _multi / _multi_queuer trio).

Reads the images of --img_lst (cv2 imread and short-edge resize in
``ImageDataset``, prefetched in order by ``DatasetEnqueuer``'s workers),
pads each batch to its largest extent, runs the batched detector on the
GPU through the pipelined runner, and writes one detection JSON per image
in the JAX CLI's schema: ``category_id``, ``cat_name``, ``score`` to 7
places, ``bbox`` as x, y, w, h to 2 places in the original image's
pixels, ``segmentation`` None. Same flags as the JAX CLI, with the same
architecture toggles as the video CLI (``ARCH_TOGGLES``), plus
``--device`` (default cuda; with no GPU it raises unless ``--device cpu``
is given). ``--compute_dtype`` defaults to bfloat16 on the GPU and
float32 on the CPU. With ``--is_efficientdet`` each image is fitted into
the model's square input, as in the video CLI. ``--model_path`` takes
the formats the video CLI's takes (utils/weights.py load_weights).

Example:
  python -m object_detection_tracking_tpu_torch.cli.obj_detect_imgs \
    --img_lst imgs.lst --out_dir out_json \
    --model_path model.npz --version 5 --num_class 16 \
    --im_batch_size 8 --num_cpu_worker 2 --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..data import DatasetEnqueuer, ImageDataset
from ..runtime import DetectionRunner
from .obj_detect_tracking import (ARCH_TOGGLES, build_config, load_model,
                                  resolve_device)


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--img_lst", required=True,
                        help="file with one image path per line")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--model_path", default=None,
                        help="a TF V2 checkpoint (directory, prefix or "
                        ".index), a tensorpack-named .npz or the native "
                        "flat .npz (EfficientDet: also automl names)")
    parser.add_argument("--version", type=int, default=4)
    parser.add_argument("--num_class", type=int, default=16)
    parser.add_argument("--is_coco_model", action="store_true")
    parser.add_argument("--use_partial_classes", action="store_true")
    parser.add_argument("--resnet18", action="store_true")
    parser.add_argument("--resnet34", action="store_true")
    parser.add_argument("--resnet50", action="store_true")
    parser.add_argument("--resnet152", action="store_true")
    parser.add_argument("--is_efficientdet", action="store_true")
    parser.add_argument("--efficientdet_modelname", default="efficientdet-d0")
    parser.add_argument("--efficientdet_max_detection_topk", type=int,
                        default=5000)
    parser.add_argument("--add_mask", action="store_true",
                        help="run the Mask-RCNN head (the JSON's "
                        "segmentation stays None, as in the JAX CLI)")
    parser.add_argument("--actasobj", action="store_true")
    # architecture toggles layered over --version (None = preset value)
    for flag in ARCH_TOGGLES:
        parser.add_argument("--" + flag, action="store_true", default=None)
    parser.add_argument("--rpn_test_post_nms_topk", type=int, default=None)
    parser.add_argument("--person_only", action="store_true",
                        help="only write Person detections")
    parser.add_argument("--only_classes", default=None,
                        help="comma list: only write these class names")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--vis_path", default="/tmp/vis")
    parser.add_argument("--vis_thres", type=float, default=0.7)
    parser.add_argument("--max_size", type=int, default=1920)
    parser.add_argument("--short_edge_size", type=int, default=1080)
    parser.add_argument("--im_batch_size", type=int, default=1)
    parser.add_argument("--num_cpu_worker", type=int, default=1)
    parser.add_argument("--prefetch", type=int, default=5)
    parser.add_argument("--threshold_conf", type=float, default=0.0001)
    parser.add_argument("--compute_dtype", default=None,
                        help="bfloat16 | float32; default bfloat16 on the "
                        "GPU, float32 on the CPU")
    parser.add_argument("--use_my_naming", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda | cuda:N | cpu (no silent CPU fallback)")
    return parser.parse_args(argv)


def _only_classes(args):
    if args.person_only:
        return {"Person", "person"}
    if args.only_classes:
        return set(args.only_classes.split(","))
    return None


def detect_images(args, cfg, runner, dataset, out_dir: str) -> int:
    """Detect every image of ``dataset`` (an ``ImageDataset`` or one of
    its kind: ``num_samples``, ``get_sample``, ``collect_batch``, batches
    of ``batch_size``) through ``runner`` and write one JSON per image
    under ``out_dir``, named after the image. Returns the image count."""
    classid2name = cfg.classid2name
    only = _only_classes(args)
    os.makedirs(out_dir, exist_ok=True)
    enq = DatasetEnqueuer(dataset, prefetch=args.prefetch,
                          num_workers=args.num_cpu_worker)

    def batch_iter():
        for batch in enq.get():
            yield batch["imgs"], batch

    count = 0
    for host, batch in runner.run(batch_iter()):
        for bi, img_name in enumerate(batch["img_names"]):
            scale = batch["scales"][bi]
            probs = host["final_probs"][bi]
            pred, vis_rows = [], []
            for i in np.flatnonzero(host["final_valid"][bi]):
                box = host["final_boxes"][bi][i] / scale
                cat_id = int(host["final_labels"][bi][i])
                if only is not None and classid2name.get(cat_id) not in only:
                    continue
                if args.visualize and probs[i] >= args.vis_thres:
                    vis_rows.append((box, cat_id, float(probs[i])))
                pred.append({
                    "category_id": cat_id,
                    "cat_name": classid2name.get(cat_id, str(cat_id)),
                    "score": float(round(float(probs[i]), 7)),
                    "bbox": [round(float(box[0]), 2), round(float(box[1]), 2),
                             round(float(box[2] - box[0]), 2),
                             round(float(box[3] - box[1]), 2)],
                    "segmentation": None,
                })
            out_name = os.path.splitext(img_name)[0] + ".json"
            with open(os.path.join(out_dir, out_name), "w") as f:
                json.dump(pred, f)
            if vis_rows:
                _visualize(args, batch["img_paths"][bi], img_name, vis_rows,
                           classid2name)
            count += 1
    return count


def _visualize(args, img_path, img_name, rows, classid2name):
    """The original image with its detections above --vis_thres drawn
    (utils/viz.py), written under --vis_path."""
    import cv2

    from ..utils.viz import draw_boxes
    im = cv2.imread(img_path)
    if im is None:
        return
    labels = ["%s_%.2f" % (classid2name.get(c, "?"), p) for _, c, p in rows]
    newim = draw_boxes(im, [b for b, _, _ in rows], labels)
    os.makedirs(args.vis_path, exist_ok=True)
    cv2.imwrite(os.path.join(args.vis_path, os.path.basename(img_name)),
                newim)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    cfg = build_config(args, device)
    runner = DetectionRunner(load_model(args, cfg, device))
    with open(args.img_lst) as f:
        paths = [line.strip() for line in f if line.strip()]
    # the configuration's sizes: the flags', or with --is_efficientdet the
    # model's square input (JAX resizes to the flags' sizes there, which
    # its EfficientDet cannot pad to its input unless they fit it)
    dataset = ImageDataset(paths, cfg.short_edge_size, cfg.max_size,
                           batch_size=args.im_batch_size)
    start = time.time()
    count = detect_images(args, cfg, runner, dataset, args.out_dir)
    elapsed = time.time() - start
    print("processed %d images in %.1fs (%.2f/s)"
          % (count, elapsed, count / max(elapsed, 1e-6)))
    return count


if __name__ == "__main__":
    main()
