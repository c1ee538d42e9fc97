#!/usr/bin/env python3
"""The rate sweep that fixed each cell's arrival rate (run once, on the card,
when a cell is defined; the benchmark's runs never sweep).

    python3 perfbench/sweep.py --workload <cell> --seed <n> --seconds <s> \\
        --rates 10 20 40 80 160

runs the cell as a run does (``pb_harness.run_cell``, the check included)
once per rate on the stream's own clock, calibrating its catalog once. Per
rate it prints one JSON line: tasks served and per wall second, mean and
95th percentile latency, the mean queue wait over each fifth of the window
(a queue that grows across the window grows along them), the pool's
counters (warm-up included), cold starts, targets, the peak memory and
whether the run was correct. The knee is the highest rate whose queue
waits do not grow.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def sweep_rate(cell: str, seed: int, seconds: float, rate: float,
               keep: dict, **kw) -> dict:
    """One rate of the sweep: ``run_cell`` with the cell's traffic at
    ``rate``; ``kw`` goes on to it (the CPU tests shrink the cell)."""
    import numpy as np

    import pb_common as pc
    import pb_harness

    over = dict(kw.pop("workload_overrides", None) or {})
    over["traffic"] = {**over.get("traffic", {}), "rate_per_s": rate}
    st: dict = {}
    out = pb_harness.run_cell(cell, seed, seconds, False, keep=keep,
                              workload_overrides=over, stats=st, **kw)
    r = st["records"]
    lat = r["latency_ms"]
    q = np.array_split(np.asarray(st["queue_ms"] or [0.0], float), 5)
    return {
        "cell": cell, "rate": rate, "correct": out["correct"],
        "tasks": len(lat), "tasks_per_s": len(lat) / st["window_s"],
        "stream_s": float(r["arrival"][-1] - r["arrival"][0]) / 1e3,
        "avg_ms": pc.mean(lat), "p95_ms": pc.percentile(lat, 95),
        "queue_ms_by_fifth": [float(x.mean()) if x.size else 0.0 for x in q],
        "pool": st["pool"], "cold": int(r["cold"].sum()),
        "targets": {t: r["target"].count(t) for t in sorted(set(r["target"]))},
        "peak_gib": st["peak_bytes"] / 2**30,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    import pb_common as pc

    if not torch.cuda.is_available():
        pc.log("the sweep runs on a CUDA card")
        return 2
    keep: dict = {}
    for rate in args.rates:
        print(json.dumps(sweep_rate(args.workload, args.seed, args.seconds,
                                    rate, keep)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
