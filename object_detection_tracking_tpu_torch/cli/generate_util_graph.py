"""Plot the PerformanceLogger utilization json (reference
generate_util_graph.py). Falls back to a text summary when matplotlib is
unavailable."""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("log_json")
    p.add_argument("out_png")
    args = p.parse_args(argv)
    with open(args.log_json) as f:
        series = json.load(f)
    t = np.asarray(series.get("time", []))
    t = t - t[0] if len(t) else t
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax1 = plt.subplots(figsize=(10, 4))
        ax1.plot(t, series["cpu_percent"], label="cpu %")
        ax1.set_xlabel("seconds")
        ax1.set_ylabel("cpu %")
        ax2 = ax1.twinx()
        ax2.plot(t, np.asarray(series["device_bytes"]) / 1e9, "r",
                 label="device GB")
        ax2.set_ylabel("device GB")
        fig.legend()
        fig.tight_layout()
        fig.savefig(args.out_png)
        print("wrote", args.out_png)
    except ImportError:
        for k in ("cpu_percent", "rss_mb", "device_bytes"):
            v = series.get(k, [])
            if v:
                print("%s: median %.1f max %.1f" % (
                    k, float(np.median(v)), float(np.max(v))))


if __name__ == "__main__":
    main()
