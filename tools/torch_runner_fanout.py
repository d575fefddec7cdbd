#!/usr/bin/env python3
"""Check and time the runner's fan-out over the cards of one process
(runtime/runner.py ``DetectionRunner(devices=)``, what
``obj_detect_tracking --device cuda:0,cuda:1`` builds): chip_smoke phase
7's detector (R101-FPN v4 with masks, 1920x1080, bf16, the fused
backbone B2 and ROIAlign B1, seeded weights) over ``--batches`` batches
of chip_smoke's BATCH synthetic frames, split over the first 2 cards and
over all of them.

Each split is held against the one-card runner fed the same frames in
batches of one replica's share, so that every forward has the same shape
on either side: the outputs must agree bit for bit, B1 and B2 must
launch 3 times a batch on each replica, and every card must hold memory.
Times: host wall per batch of BATCH frames through ``runner.run``
(median over the batches after one warm-up batch) for one card and each
split. Prints one JSON line (and writes it to ``--out``); exits 1 on a
difference or with fewer than 2 cards.

    python3 tools/torch_runner_fanout.py [--batches 6]
        [--out chiprun_out/runner_fanout.json]
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batches", type=int, default=6)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import chip_smoke as cs          # blocks jax; the synthetic video
    import numpy as np
    import torch

    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.runtime import DetectionRunner

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print(f"needs 2 or more CUDA GPUs, found {n_cards}", file=sys.stderr)
        return 1
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    video = cs.SyntheticVideo(cs.BATCH * (args.batches + 1), h=cs.ACTEV_H,
                              w=cs.ACTEV_W)
    frames = np.stack([video.read()[1] for _ in range(video.num_frames)])
    batches = [frames[i:i + cs.BATCH]
               for i in range(0, len(frames), cs.BATCH)]
    with tempfile.TemporaryDirectory() as tmp:
        _, cfg, tree = cs.actev_setup(tmp, cards[0])
    model = cs.build_model(cfg, tree, cards[0])
    # the replicas are copied before any forward, as the CLI builds them
    splits = {k: DetectionRunner(model, devices=cards[:k])
              for k in sorted({2, n_cards}) if cs.BATCH % k == 0}

    def run(runner, size):
        """The runner over ``batches`` cut into batches of ``size``: the
        outputs of each, in order, the launches of B1 and B2, and the host
        wall per BATCH frames after the first batch."""
        cuts = [(b[i:i + size], n) for n, b in enumerate(batches)
                for i in range(0, len(b), size)]
        RA.multilevel_roi_align_cuda.launches = 0
        RS.fused_bottleneck_stage_cuda.launches = 0
        outs, stamps = [], []
        for host, n in runner.run(iter(cuts)):
            outs.append(host)
            stamps.append((n, time.perf_counter()))
        ends = {}
        for n, t in stamps:
            ends[n] = t
        walls = [1e3 * (ends[n] - ends[n - 1])
                 for n in range(1, len(batches))]
        return (outs, RA.multilevel_roi_align_cuda.launches,
                RS.fused_bottleneck_stage_cuda.launches,
                sorted(walls)[len(walls) // 2])

    def joined(outs, per):
        """The outputs of consecutive groups of ``per`` batches joined."""
        return [{k: np.concatenate([o[k] for o in outs[i:i + per]])
                 for k in outs[i]} for i in range(0, len(outs), per)]

    with torch.inference_mode():
        one, roi_one, stage_one, ms_one = run(DetectionRunner(model),
                                              cs.BATCH)
        if roi_one != 3 * len(batches) or stage_one != 3 * len(batches):
            raise AssertionError(f"one card: roi_align {roi_one}, bottleneck "
                                 f"stage {stage_one} launches")
        res = {"card": cs.card_line(), "torch": torch.__version__,
               "cards": n_cards, "frames_per_batch": cs.BATCH,
               "frame": [cs.ACTEV_H, cs.ACTEV_W], "batches": len(batches),
               "one_card_ms_per_batch": ms_one, "splits": {}}
        ok = True
        for k, runner in splits.items():
            per = cs.BATCH // k
            got, roi_n, stage_n, ms = run(runner, cs.BATCH)
            ref = joined(run(DetectionRunner(model), per)[0], k)
            diff = max(float(np.abs(g[key].astype(np.float64)
                                    - r[key].astype(np.float64)).max())
                       for g, r in zip(got, ref) for key in r)
            share = min(cs.match_share(r, g)[0] for g, r in zip(got, ref))
            mem = [torch.cuda.max_memory_allocated(d) for d in cards[:k]]
            split = {"replica_frames": per, "ms_per_batch": ms,
                     "roi_align_launches": roi_n,
                     "bottleneck_stage_launches": stage_n,
                     "max_abs_diff": diff, "match_share": share,
                     "card_bytes_max": mem,
                     "outputs_on": sorted({str(r.device)
                                           for r in runner.replicas})}
            res["splits"][str(k)] = split
            print(f"{k} cards, {per} frames a replica: {ms:.1f} ms a batch "
                  f"(one card {ms_one:.1f}); launches roi_align {roi_n}, "
                  f"bottleneck stage {stage_n} (want {3 * k * len(batches)} "
                  f"each); max |diff| against one card {diff:.3g}, match "
                  f"share {share:.4f}; card bytes {mem}", flush=True)
            ok &= (len(got) == len(batches) and diff == 0.0
                   and roi_n == stage_n == 3 * k * len(batches)
                   and all(m > 0 for m in mem))
    res["ok"] = ok
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
