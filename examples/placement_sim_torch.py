"""Sweep study on the PyTorch port: how the two knobs of the paper's
framework behave.

The counterpart of ``examples/placement_sim.py``, through ``repro_torch``
only, on the CUDA card by default. Reproduces Fig. 5 (cost vs deadline δ)
and Fig. 6 (latency vs α) behavior for one app each, printing ASCII curves.

    PYTHONPATH=src python examples/placement_sim_torch.py
    PYTHONPATH=src python examples/placement_sim_torch.py --device cpu
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

N_INPUTS = 300
N_TASKS = 300
DEADLINES_MS = (4500, 5000, 5500, 6000, 6500, 7000)
ALPHAS = (0.0, 0.01, 0.02, 0.03, 0.05, 0.1)


def bar(x, scale, width=40):
    n = int(min(x / scale, 1.0) * width)
    return "#" * n


def run(device=None, *, n_inputs: int = N_INPUTS, n_tasks: int = N_TASKS,
        log=None) -> dict:
    """Sweep MinCost's deadline and MinLatency's α over STT; returns the
    result of every point by knob value and, under ``"headline"``, the
    printed numbers."""
    dev = resolve_device(device)
    say = log or (lambda *_: None)

    say("fitting STT models...")
    twin, models = fit_app("STT", seed=0, n_inputs=n_inputs,
                           configs=(768, 1152, 1280, 1664))
    tasks = twin.workload(n_tasks, seed=5)

    say("\nFig.5-style: total cost and edge executions vs deadline δ (STT)")
    say(f"{'δ (s)':>6} {'cost $':>10} {'edge#':>6}")
    by_deadline = {}
    for d in DEADLINES_MS:
        pred = build_predictor(models, configs=(768, 1152, 1280, 1664))
        eng = DecisionEngine(predictor=pred, policy=MinCostPolicy(float(d)),
                             device=dev)
        res = PlacementRuntime(eng, TwinBackend(twin, seed=9)).serve(tasks)
        by_deadline[d] = res
        say(f"{d/1e3:>6.1f} {res.total_actual_cost:>10.6f} {res.n_edge:>6d} "
            f"|{bar(res.n_edge, 300)}")

    say("\nFig.6-style: average latency vs α (STT, C_max=$3.07e-5)")
    say(f"{'α':>6} {'avg s':>8} {'budget rem%':>12}")
    by_alpha = {}
    for a in ALPHAS:
        pred = build_predictor(models, configs=(1152, 1280, 1664))
        eng = DecisionEngine(predictor=pred,
                             policy=MinLatencyPolicy(3.0747e-5, a),
                             device=dev)
        res = PlacementRuntime(eng, TwinBackend(twin, seed=9)).serve(tasks)
        by_alpha[a] = res
        rem = 100 - res.pct_budget_used
        say(f"{a:>6.2f} {res.avg_actual_latency_ms/1e3:>8.3f} {rem:>11.1f}% "
            f"|{bar(res.avg_actual_latency_ms, 20e3)}")
    return {"by_deadline": by_deadline, "by_alpha": by_alpha,
            "headline": {
                "cost_by_deadline_ms": {d: r.total_actual_cost
                                        for d, r in by_deadline.items()},
                "avg_s_by_alpha": {a: r.avg_actual_latency_ms / 1e3
                                   for a, r in by_alpha.items()}}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    run(args.device, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
