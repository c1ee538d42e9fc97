#!/usr/bin/env python3
"""Time K4b, the attention backward, and K4's serving call of two checkouts
of the port on one card.

    python3 scripts/k4b_ab.py --other DIR [--pairs 1] [--out build/k4b_ab]

``DIR`` is the root of another checkout (for example the parent commit,
unpacked with ``git archive``). The script runs ``--pairs`` pairs of
processes in turn, each pair in the other order than the last (other,
this, this, other, ...), so that drift on the card shows as a difference
between runs of one checkout. Each process imports ``repro_torch`` from its
checkout and this checkout's ``chip_smoke.py`` for the inputs, limits and
timers, builds the checkout's attention libraries, and calls its
``flash_attention_bwd_bhsd`` at ``chip_smoke.py``'s training shapes
(``TRAIN_ATTN``: llama3.2-1b, q (2, 32, 2048, 64), 8 KV heads, causal;
``GRIFFIN_ATTN``: recurrentgemma-9b, q (1, 16, 4096, 256), one KV head,
window 2048) in bf16 and float32, on the output of the checkout's K4 (and
its row log-sum-exp where the checkout's K4 writes one). Each call is
timed eagerly by CUDA events (``ms``) and per CUDA kernel by
``torch.profiler`` (``device_us``), and held against the plain version
with ``chip_smoke.py``'s limits (bf16 rows within ``K4B_ROW_TOL``, float32
within ``K4B_F32_TOL``). K4 is timed as the serving path calls it (bf16,
no row statistics) from a CUDA graph (``graph_ms``) at ``chip_smoke.py``'s
phase-2 shapes: llama3.2-1b's prefill (q (1, 32, 32, 64), 8 KV heads), a
causal S = 2048 prefill and recurrentgemma-9b's (q (1, 16, 4096, 256), one
KV head, window 2048). The script fails if any run breaks a limit, if two
runs of one checkout give different bits, or if the two checkouts' K4
outputs differ in a bit. Prints one JSON line per process and a summary:
each case's ms per checkout (median of its runs) and the ratio.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("other", "this")


def cases(smoke):
    import torch

    return {"llama_bf16": (smoke.TRAIN_ATTN, torch.bfloat16, 0, 10),
            "griffin_bf16": (smoke.GRIFFIN_ATTN, torch.bfloat16, smoke.WINDOW, 5),
            "llama_f32": (smoke.TRAIN_ATTN, torch.float32, 0, 2),
            "griffin_f32": (smoke.GRIFFIN_ATTN, torch.float32, smoke.WINDOW, 2)}


# K4's serving calls: (B, H, Hkv, Sq, Skv, D), window, graph reps
K4_CASES = {"k4_prefill": ((1, 32, 8, 32, 32, 64), 0, 200),
            "k4_s2048": ((1, 32, 8, 2048, 2048, 64), 0, 50),
            "k4_griffin": ((1, 16, 1, 4096, 4096, 256), 2048, 10)}


def measure(root: Path, tag: str) -> dict:
    """In this process: time K4b and K4 of the checkout at ``root``."""
    sys.path[:0] = [str(root / "src")]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as K

    if Path(K.__file__).resolve().parents[4] != root.resolve():
        raise SystemExit(f"imported {K.__file__}, not {root}'s port")
    _build.build_all(("flash_attention", "flash_attention_bwd"))
    takes_lse = "lse" in inspect.signature(K.flash_attention_bwd_bhsd).parameters
    dev = torch.device("cuda", 0)
    out = {"tag": tag, "root": str(root), "lse_from_k4": takes_lse,
           "cases": {}}
    for name, (shape, dtype, window, reps) in cases(smoke).items():
        B, H, Hkv, S, D = shape
        q, k, v = smoke.attn_inputs((B, H, Hkv, S, S, D), dtype, dev,
                                    seed=D + window)
        g = torch.as_tensor(np.random.default_rng(D).normal(size=(B, H, S, D)),
                            dtype=dtype).to(dev)
        kw = dict(causal=True, window=window)
        if takes_lse:
            lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
            o = K.flash_attention_bhsd(q, k, v, lse=lse, **kw)
            kw["lse"] = lse
        else:
            o = K.flash_attention_bhsd(q, k, v, **kw)

        def call():
            return K.flash_attention_bwd_bhsd(q, k, v, o, g, **kw)

        got = call()
        want = K.flash_attention_bwd_plain(q, k, v, o, g, causal=True,
                                           window=window)
        torch.cuda.synchronize()
        res = {}
        if dtype == torch.float32:
            res["rel_err"] = smoke.k4b_f32_err(got, want)
            ok = res["rel_err"] <= smoke.K4B_F32_TOL
        else:
            res["row_err"] = smoke.k4b_row_err(got, want)
            ok = res["row_err"] <= smoke.K4B_ROW_TOL
        if not ok:
            raise SystemExit(f"{tag} {name}: outside the limit: {res}")
        digest = hashlib.sha1()
        for t in got:
            digest.update(t.float().cpu().numpy().tobytes())
        del got, want
        res["sha1"] = digest.hexdigest()[:16]
        res["ms"] = smoke.cuda_ms(call, reps)
        res["device_us"] = {n: us for n, us in
                            smoke.kernel_device_us(call, 3).items()
                            if n.startswith("fa_bwd")}
        out["cases"][name] = res
        del q, k, v, g, o
        kw.clear()
        torch.cuda.empty_cache()
    for name, (shape, window, reps) in K4_CASES.items():
        q, k, v = smoke.attn_inputs(shape, torch.bfloat16, dev,
                                    seed=shape[4] + window)

        def call():
            return K.flash_attention_bhsd(q, k, v, causal=True, window=window)

        got = call()
        torch.cuda.synchronize()
        out["cases"][name] = {
            "sha1": hashlib.sha1(got.float().cpu().numpy().tobytes())
            .hexdigest()[:16],
            "ms": smoke.graph_ms(call, reps)}
        del q, k, v, got
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k4b_ab")
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
    for name in runs["this"][0]["cases"]:
        row = {}
        for variant in VARIANTS:
            cs = [r["cases"][name] for r in runs[variant]]
            if len({c["sha1"] for c in cs}) != 1:
                raise SystemExit(f"{variant} {name}: runs differ in bits")
            row[f"{variant}_ms"] = [c["ms"] for c in cs]
            row[f"{variant}_median_ms"] = statistics.median(c["ms"] for c in cs)
        if name in K4_CASES and len({r["cases"][name]["sha1"] for v in
                                     VARIANTS for r in runs[v]}) != 1:
            raise SystemExit(f"{name}: the checkouts' K4 outputs differ")
        row["speedup"] = row["other_median_ms"] / row["this_median_ms"]
        summary[name] = row
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
