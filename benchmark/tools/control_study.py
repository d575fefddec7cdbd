"""The readings that set each cell's limits: the program's on a dozen
seeds or more and the float8 control's (the reference in bfloat16's place,
one step below it) on the same frames, and with ``--faults`` each planted
fault's, all at the cell's own sizes over a short window, in one process.

    python3 benchmark/tools/control_study.py --workload actev_video_1080p \
        --seeds 12 --seconds 4 --out chiprun_out/study_actev.json

Prints one JSON line a run; writes them all to ``--out``.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first_seed", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--faults", type=int, default=0,
                   help="seeds on which each planted fault is read")
    p.add_argument("--fault", action="append",
                   help="read only this fault (repeatable; default: all)")
    p.add_argument("--out", required=True)
    a = p.parse_args()
    from benchmark.harness import faults, spec
    files = spec.cell(a.workload)
    drv = spec.driver(files["cell"]["driver"])
    rows = []

    def record(kind, seed, res):
        row = {"workload": a.workload, "kind": kind, "seed": seed,
               "readings": res["readings"], "correct": res["correct"],
               "compared": res["compared"], "frames": res["obs"]["frames"],
               "setup_s": res["setup_s"], "video_fps": res["video_fps"],
               "tracked_dets_per_frame": res["tracked_dets_per_frame"],
               "check_s": res["check_s"]}
        if res.get("control_readings") is not None:
            row["control"] = res["control_readings"]
        rows.append(row)
        print(json.dumps(row), flush=True)

    for i in range(a.seeds):
        seed = a.first_seed + 7919 * i
        t = time.perf_counter()
        record("program", seed, drv.run(files, seed, a.seconds, False, t,
                                        control=True))
    for name, fault in faults.FAULTS.items():
        if a.fault and name not in a.fault:
            continue
        for i in range(a.faults):
            seed = a.first_seed + 104729 * (i + 1)
            t = time.perf_counter()
            record(name, seed, drv.run(files, seed, a.seconds, False, t,
                                       fault=fault))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
