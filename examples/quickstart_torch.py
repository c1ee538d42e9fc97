"""Quickstart on the PyTorch port: the paper's framework in one file.

The counterpart of ``examples/quickstart.py``, through ``repro_torch``
only, on the CUDA card by default. Fits the performance models for the
Face Detection app against the AWS twin (paper Sec. IV), then runs both
placement policies (Sec. III-B) through the event-driven simulator
(Sec. VI-A) and prints the headline metrics.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys

from repro_torch import resolve_device
from repro_torch.core.decision import (
    DecisionEngine,
    MinCostPolicy,
    MinLatencyPolicy,
)
from repro_torch.core.fit import build_predictor, fit_app
from repro_torch.core.runtime import PlacementRuntime, TwinBackend

N_INPUTS = 400
N_TASKS = 600


def run(device=None, *, n_inputs: int = N_INPUTS, n_tasks: int = N_TASKS,
        log=None) -> dict:
    """Fit FD, serve ``n_tasks`` arrivals under MinLatency, MinCost and
    edge-only; returns the three results and, under ``"headline"``, the
    printed numbers."""
    dev = resolve_device(device)
    say = log or (lambda *_: None)

    # 1. Collect measurements from the (simulated) AWS environment and fit
    #    the component models: upload/ridge, GBRT compute, normal
    #    start/store.
    say("fitting performance models for FD (dlib face detection)...")
    twin, models = fit_app("FD", seed=0, n_inputs=n_inputs,
                           configs=(1280, 1408, 1536, 1664, 2048))
    say(f"  cloud end-to-end MAPE: {models.cloud_e2e_mape:.2f}%   "
        f"edge: {models.edge_e2e_mape:.2f}%   (paper Table II: 13.24 / 3.78)")

    # 2. A fresh Poisson workload (4 frames/s smart camera).
    tasks = twin.workload(n_tasks, seed=42)

    # 3a. Minimize latency subject to a per-task budget (paper Alg. 1).
    #     The unified runtime: ONE serve loop over a pluggable execution
    #     backend (here the AWS twin; repro_torch.serving swaps in the live
    #     executor pool).
    predictor = build_predictor(models, configs=(1536, 1664, 2048))
    engine = DecisionEngine(predictor=predictor,
                            policy=MinLatencyPolicy(c_max=2.96997e-5,
                                                    alpha=0.02),
                            device=dev)
    minlat = PlacementRuntime(engine, TwinBackend(twin, seed=7)).serve(tasks)
    say(f"\nmin-latency: avg {minlat.avg_actual_latency_ms/1e3:.3f}s/task, "
        f"pred err {minlat.latency_error_pct:.2f}%, "
        f"budget used {minlat.pct_budget_used:.1f}%, "
        f"warm/cold mispredictions {minlat.n_warm_cold_mismatches}/"
        f"{minlat.n}")

    # 3b. Minimize cost subject to a 4.5 s deadline.
    predictor = build_predictor(models, configs=(1280, 1408, 1664))
    engine = DecisionEngine(predictor=predictor, policy=MinCostPolicy(4500.0),
                            device=dev)
    mincost = PlacementRuntime(engine, TwinBackend(twin, seed=7)).serve(tasks)
    say(f"min-cost:    total ${mincost.total_actual_cost:.6f}, "
        f"pred err {mincost.cost_error_pct:.2f}%, "
        f"deadline violations {mincost.pct_deadline_violated:.2f}%")

    # 4. The punchline (paper Sec. VI-B): dynamic placement vs edge-only.
    engine0 = DecisionEngine(
        predictor=build_predictor(models, configs=(1536,)),
        policy=MinLatencyPolicy(c_max=0.0, alpha=0.0), device=dev)
    edge = PlacementRuntime(engine0, TwinBackend(twin, seed=7)).serve(tasks)
    # the reference divides by the result served last, the min-cost one
    speedup = edge.avg_actual_latency_ms / mincost.avg_actual_latency_ms
    say(f"\nedge-only:   avg {edge.avg_actual_latency_ms/1e3:.1f}s/task "
        f"(queueing collapse) → dynamic placement is "
        f"{speedup:.0f}x faster")
    return {"minlat": minlat, "mincost": mincost, "edge_only": edge,
            "cloud_mape": models.cloud_e2e_mape,
            "edge_mape": models.edge_e2e_mape, "speedup": speedup,
            "headline": {
                "minlat_avg_s": minlat.avg_actual_latency_ms / 1e3,
                "mincost_total": mincost.total_actual_cost,
                "edge_only_avg_s": edge.avg_actual_latency_ms / 1e3,
                "speedup": speedup}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    run(args.device, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
