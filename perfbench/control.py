#!/usr/bin/env python3
"""The readings the check's limits are set from (run on the card when a
limit is set; the benchmark's runs never run it).

    python3 perfbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

calibrates the cell once, then per seed serves a window of the cell's own
load as a run does and runs the check with the control in the program's
place: the float32 reference computed in fp8 (``reference/_common.py``'s
``Prec``) wherever the configuration computes in bf16, at the executions
the window served. Per seed it prints one JSON line: ``correct`` (which
a control must make false), every number compared with the control's
value beside its limit (the upper readings), and the program's own readings
of the same executions (the lower readings).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    import pb_common as pc
    import pb_harness

    if not torch.cuda.is_available():
        pc.log("the control runs on a CUDA card")
        return 2
    keep: dict = {}
    for seed in args.seeds:
        out = pb_harness.run_cell(args.workload, seed, args.seconds, False,
                                  keep=keep, control="fp8")
        print(json.dumps({
            "cell": args.workload, "seed": seed, "correct": out["correct"],
            "checks": out["checks"],
            "program": out["readings"]["served"],
            "control": out["readings"]["fp8"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
