#!/usr/bin/env python3
"""Time K6b, the SSD scan's backward, of two checkouts of the port on one
card.

    python3 scripts/k6b_ab.py --other DIR [--pairs 1] [--out build/k6b_ab]

``DIR`` is the root of another checkout (for example the parent commit,
unpacked with ``git archive``). The script runs ``--pairs`` pairs of
processes in turn, each pair in the other order than the last (other,
this, this, other, ...), so that drift on the card shows as a difference
between runs of one checkout. Each process imports ``repro_torch`` from its
checkout and this checkout's ``chip_smoke.py`` for the inputs, limits and
timers, builds the checkout's SSD libraries, and calls its
``ssd_scan_bwd_bhsd`` as ``SSDScanFn`` does at ``chip_smoke.py``'s K6b
case: mamba2-780m's first layer's inputs at B=2, S=2048 (x (2, 48, 2048,
64), B and C (2, 2048, 128), 16 chunks of 128), K6's workspace of chunk
states, dy and the final state's cotangent drawn N(0, 1), in bf16 and in
float32. Each call is timed eagerly by CUDA events (``ms``) and per CUDA
kernel by ``torch.profiler`` (``device_us``), and held against the plain
version with ``chip_smoke.py``'s limits (bf16 rows within
``K4B_ROW_TOL``, float32 within ``K6B_TOL`` of max(1, |grad|)). The
script fails if any run breaks a limit or if two runs of one checkout
give different bits. Prints one JSON line per process and a summary: each
case's ms per checkout (median of its runs) and the ratio.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("other", "this")
CASES = {"bf16": 10, "f32": 3}  # dtype: timed calls


def measure(root: Path, tag: str) -> dict:
    """In this process: time K6b of the checkout at ``root``."""
    sys.path[:0] = [str(root / "src")]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel as K

    if Path(K.__file__).resolve().parents[4] != root.resolve():
        raise SystemExit(f"imported {K.__file__}, not {root}'s port")
    _build.build_all(("ssd_scan", "ssd_scan_bwd"))
    dev = torch.device("cuda", 0)
    inputs, chunk = smoke.ssd_layer_inputs(
        dev, ((smoke.SSM_TRAIN_B, smoke.SSM_TRAIN_S),))
    xs, dt, A, B0, C0 = inputs[(smoke.SSM_TRAIN_B, smoke.SSM_TRAIN_S)]
    out = {"tag": tag, "root": str(root), "cases": {}}
    for name, reps in CASES.items():
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        x, B, C = xs.to(dtype).transpose(1, 2), B0.to(dtype), C0.to(dtype)
        dtt = dt.transpose(1, 2)
        b, H, S, hd = x.shape
        ds = B.shape[-1]
        rng = np.random.default_rng(5)
        dy = torch.as_tensor(rng.normal(size=(b, S, H, hd)),
                             dtype=torch.float32,
                             device=dev).to(dtype).transpose(1, 2)
        dstate = torch.as_tensor(rng.normal(size=(b, H, hd, ds)),
                                 dtype=torch.float32, device=dev)
        work = torch.empty(K.work_floats(b, H, S, hd, ds, chunk),
                           dtype=torch.float32, device=dev)
        K.ssd_scan_bhsd(x, dtt, A, B, C, chunk=chunk, work=work)

        def call():
            dx = torch.empty((b, S, H, hd), dtype=dtype,
                             device=dev).transpose(1, 2)
            return K.ssd_scan_bwd_bhsd(x, dtt, A, B, C, dy, dstate,
                                       chunk=chunk, work=work, dx=dx)

        got = call()
        want = K.ssd_scan_bwd_plain(x, dtt, A, B, C, dy, dstate, chunk=chunk)
        torch.cuda.synchronize()
        res = {}
        if dtype == torch.float32:
            res["rel_err"] = smoke.k4b_f32_err(got, want)
            ok = res["rel_err"] <= smoke.K6B_TOL
        else:
            rows = (got[0], got[1], got[2][None], got[3], got[4])
            res["row_err"] = smoke.k4b_row_err(
                rows, (want[0], want[1], want[2][None], want[3], want[4]))
            ok = res["row_err"] <= smoke.K4B_ROW_TOL
        if not ok:
            raise SystemExit(f"{tag} {name}: outside the limit: {res}")
        digest = hashlib.sha1()
        for t in got:
            digest.update(t.float().cpu().numpy().tobytes())
        del got, want
        res["sha1"] = digest.hexdigest()[:16]
        res["ms"] = smoke.cuda_ms(call, reps)
        res["device_us"] = smoke.kernel_device_us(call, 3)
        out["cases"][name] = res
        del x, B, C, dy, work
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k6b_ab")
    ap.add_argument("--measure", choices=VARIANTS, help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = {"other": args.other.resolve(), "this": ROOT}
    if args.measure:
        print(json.dumps(measure(roots[args.measure], args.measure)),
              flush=True)
        return 0

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    runs: dict[str, list[dict]] = {v: [] for v in VARIANTS}
    for i in range(args.pairs):
        order = VARIANTS if i % 2 == 0 else VARIANTS[::-1]
        for variant in order + order[::-1]:
            proc = subprocess.run(
                [sys.executable, __file__, "--other", str(args.other),
                 "--measure", variant], capture_output=True, text=True,
                timeout=1200)
            (args.out / f"{variant}_{len(runs[variant])}.log").write_text(
                proc.stdout + proc.stderr)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:])
                raise SystemExit(f"{variant} run failed")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs[variant].append(line)
    summary = {"card": card}
    for name in CASES:
        row = {}
        for variant in VARIANTS:
            cs = [r["cases"][name] for r in runs[variant]]
            if len({c["sha1"] for c in cs}) != 1:
                raise SystemExit(f"{variant} {name}: runs differ in bits")
            row[f"{variant}_ms"] = [c["ms"] for c in cs]
            row[f"{variant}_median_ms"] = statistics.median(c["ms"] for c in cs)
        row["speedup"] = row["other_median_ms"] / row["this_median_ms"]
        summary[name] = row
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
