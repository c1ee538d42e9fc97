#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): live
placement serving through ``PlacementRuntime.serve_async`` on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once from the root of a checkout and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``, and a ``breakdown``) and, last, ``checks``: every number the
check compared beside its limit, which also end standard error. It exits
2, printing no result, without a CUDA card or with fewer than the cell
asks for; 3 when the process holds JAX or the JAX package after the window.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import pb_common as pc

    entry = pc.cell_entry(pc.benchmark(), args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        pc.log(f"{args.workload} needs {entry['chips']} CUDA card(s); "
               f"{torch.cuda.device_count()} available")
        return 2
    import pb_harness

    out = pb_harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T0)
    found = pb_harness.forbidden_modules()
    if found:
        pc.log(f"the process holds {', '.join(found)} after the window: the "
               "program under test must not load JAX or the JAX package")
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        pc.log(f"check {name}: {c['value']} (limit {c['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
