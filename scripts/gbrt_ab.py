#!/usr/bin/env python3
"""Time the GBRT kernels (K1, K2) of two checkouts of the port on one card.

    python3 scripts/gbrt_ab.py --other DIR [--pairs 2]
        [--out build/gbrt_ab]

``DIR`` is the root of another checkout (for example the parent commit,
unpacked with ``git archive``). The script runs ``--pairs`` pairs of
processes in turn, each pair in the other order than the last (other,
this, this, other, ...), so that drift on the card shows as a difference
between runs of one checkout. Each process imports ``repro_torch``
from its checkout and this checkout's ``chip_smoke.py`` for the stream and
the timers, builds the checkout's ``gbrt_predict`` library, and calls its
entry points ``gbrt_predict_configs`` (K1: the four configs over the first
65,536-row chunk of ``chip_smoke.py``'s stream) and ``gbrt_predict`` (K2:
the same sizes beside a memory of 1792) in float64. Each is timed from a
CUDA graph of 20 calls (device time, ``graph_ms``), eagerly over 200 calls
by CUDA events (``cuda_ms``), on the host clock (``host_us``: the host's
work for one call, wrapper and launches) and per CUDA kernel by
``torch.profiler`` (``device_us``). The script fails unless every run's
outputs are bit-identical. Prints one JSON line per process and a
summary: each number's runs, median and quartiles per checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("other", "this")


def host_us(fn, reps: int = 400, rounds: int = 5) -> float:
    """Host microseconds per call: the least, over ``rounds``, of ``reps``
    calls issued back to back on the host clock (the card drains between
    rounds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return best


def measure(root: Path, out: Path, tag: str) -> dict:
    """In this process: time K1 and K2 of the checkout at ``root``."""
    sys.path[:0] = [str(root / "src")]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.gbrt_predict.ops import (
        gbrt_predict,
        gbrt_predict_configs,
    )

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all(("gbrt_predict",))
    build_s = time.perf_counter() - t0
    ctx = cs.make_stream()
    model = ctx["models"].comp_cloud
    sizes = torch.as_tensor(np.asarray(ctx["chunks"][0].size, np.float64),
                            device=dev)
    mem = torch.tensor([float(m) for m in cs.CONFIGS], dtype=torch.float64,
                       device=dev)
    models = [model] * len(cs.CONFIGS)
    x2 = torch.stack([sizes, torch.full_like(sizes, 1792.0)], 1).contiguous()

    def k1():
        return gbrt_predict_configs(models, mem, sizes)

    def k2():
        return gbrt_predict(model, x2)

    out.mkdir(parents=True, exist_ok=True)
    np.save(out / f"{tag}_k1.npy", k1().cpu().numpy())
    np.save(out / f"{tag}_k2.npy", k2().cpu().numpy())
    res = {"tag": tag, "root": str(root), "build_s": build_s}
    for name, fn in (("k1", k1), ("k2", k2)):
        res[f"{name}_graph_ms"] = cs.graph_ms(fn, 20)
        res[f"{name}_eager_ms"] = cs.cuda_ms(fn, 200)
        res[f"{name}_host_us"] = host_us(fn)
        res[f"{name}_device_us"] = cs.kernel_device_us(fn)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "gbrt_ab")
    ap.add_argument("--pairs", type=int, default=2,
                    help="pairs of runs, each pair in the other order")
    ap.add_argument("--variant", choices=VARIANTS, help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variant is not None:
        root = args.other.resolve() if args.variant == "other" else ROOT
        print(json.dumps(measure(root, args.out, args.tag)), flush=True)
        return 0
    import numpy as np

    order = [v for i in range(args.pairs)
             for v in (VARIANTS if i % 2 == 0 else VARIANTS[::-1])]
    runs = []
    for i, variant in enumerate(order):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--other",
             str(args.other), "--out", str(args.out), "--variant", variant,
             "--tag", f"{i}_{variant}"],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        runs[-1]["variant"] = variant
        print(json.dumps(runs[-1]), flush=True)
    for k in ("k1", "k2"):
        outs = [np.load(args.out / f"{r['tag']}_{k}.npy") for r in runs]
        if not all(np.array_equal(o.view(np.int64), outs[0].view(np.int64))
                   for o in outs):
            print(f"{k}: the runs' outputs differ", file=sys.stderr)
            return 1
    summary = {}
    for k in ("k1_graph_ms", "k1_eager_ms", "k1_host_us", "k2_graph_ms",
              "k2_eager_ms", "k2_host_us"):
        summary[k] = {}
        for v in VARIANTS:
            vals = [r[k] for r in runs if r["variant"] == v]
            q1, med, q3 = np.percentile(vals, [25, 50, 75])
            summary[k][v] = {"runs": vals, "median": med, "q1": q1, "q3": q3}
    print(json.dumps({"outputs_bit_identical": True, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
