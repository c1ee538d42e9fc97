"""End-to-end serving driver on the PyTorch port: dynamic task placement
over REAL model executions.

The counterpart of ``examples/serve_placement.py``, through ``repro_torch``
only, on the CUDA card by default. This is the live-prototype path (paper
Sec. VI-B) on the accelerator-fleet adaptation: slice configs
λ_m = {2, 4, 8}-chip executors serving a (reduced) llama3.2-1b; cold start
= weights drawn on the device, steps warmed up and (on the card) captured
into CUDA graphs whose replays run the attention kernels K4 and K5; a
Poisson stream of LLM requests flows through the Decision Engine; every
latency is wall-clock measured.

    PYTHONPATH=src python examples/serve_placement_torch.py
    PYTHONPATH=src python examples/serve_placement_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.core.decision import MinLatencyPolicy
from repro_torch.core.pricing import SlicePricing
from repro_torch.serving.executors import SliceSpec
from repro_torch.serving.placement import (
    calibrate_catalog,
    llm_workload,
    make_live_runtime,
)

MODEL = "llama3.2-1b"
CHIPS = (2, 4, 8)
N_REQUESTS = 80
RATE_PER_S = 50.0       # virtual arrival clock (~4× edge capacity)
MEAN_TOKENS = 4096.0
C_MAX = 2.0e-4          # $/request budget
ALPHA = 0.02


def run(device=None, *, n_requests: int = N_REQUESTS,
        mean_tokens: float = MEAN_TOKENS, log=None) -> dict:
    """Calibrate the slice catalog on the smoke-size reduction of
    llama3.2-1b and serve ``n_requests`` Poisson requests of
    ``mean_tokens`` tokens on average live; returns the catalog, the
    runtime, the result, its placement histogram and, under
    ``"headline"``, the printed numbers."""
    dev = resolve_device(device)
    say = log or (lambda *_: None)
    cfg = smoke_config(MODEL)
    specs = [SliceSpec(f"slice{c}", c, tokens_per_step=4) for c in CHIPS]

    say(f"calibrating {len(specs)} slice configs on reduced {MODEL} "
        f"(real cold starts on {dev.type})...")
    cat = calibrate_catalog(cfg, specs, n_tasks=12, n_cold=1, seed=0,
                            pricing=SlicePricing(quantum_s=0.1),
                            mean_tokens=mean_tokens, device=dev)
    say(f"  cold start (weights+warm-up+graphs): "
        f"{cat.start_cold.mean:.0f} ms   "
        f"warm start: {cat.start_warm.mean:.2f} ms")

    tasks = llm_workload(n_requests, rate_per_s=RATE_PER_S, seed=1,
                         mean_tokens=mean_tokens)
    # The SAME PlacementRuntime serve loop as the simulator, over the live
    # pool.
    runtime = make_live_runtime(cat, MinLatencyPolicy(C_MAX, ALPHA),
                                t_idl_ms=10_000.0, device=dev)
    say(f"serving {n_requests} requests (Poisson {RATE_PER_S}/s) through the "
        "Decision Engine...")
    res = runtime.serve(tasks)

    hist = {}
    for r in res.records:
        hist[r.target] = hist.get(r.target, 0) + 1
    hist = dict(sorted(hist.items()))

    say(f"\navg end-to-end latency : {res.avg_actual_latency_ms:.1f} ms "
        f"(p95 {res.p95_actual_latency_ms:.1f} ms)")
    say(f"latency prediction err : {res.latency_error_pct:.2f} %  "
        "(paper live prototype: 5.65 %)")
    say(f"total cost             : ${res.total_actual_cost:.6f} "
        f"({res.pct_budget_used:.1f} % of budget)")
    say(f"warm/cold mismatches   : {res.n_warm_cold_mismatches}/{res.n}")
    say(f"placement histogram    : {hist}")
    return {"catalog": cat, "runtime": runtime, "result": res,
            "n_requests": n_requests, "histogram": hist,
            "headline": {"served": res.n, "failed": res.n_failed,
                         "shed": res.n_shed,
                         "avg_ms": res.avg_actual_latency_ms,
                         "p95_ms": res.p95_actual_latency_ms,
                         "latency_error_pct": res.latency_error_pct,
                         "placements": hist}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    run(args.device, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
