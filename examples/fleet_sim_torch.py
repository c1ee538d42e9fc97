"""Fleet quickstart on the PyTorch port: place a bursty workload across a
3-device edge fleet.

The counterpart of ``examples/fleet_sim.py``, through ``repro_torch``
only, on the CUDA card by default. The paper assumes ONE smart edge device;
this example runs its framework over an ``EdgeFleet`` — two full-speed
cameras plus one older half-speed unit — with the cloud configs as
overflow. It compares:

- the single-edge configuration (the paper's setup),
- round-robin device balancing (backlog-blind baseline),
- least-predicted-wait balancing (the default ``EdgeBalancer``),

on skewed (bursty) arrivals, then prints the per-device utilization and
queue-wait summaries the fleet metrics expose.

    PYTHONPATH=src python examples/fleet_sim_torch.py
    PYTHONPATH=src python examples/fleet_sim_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys

from repro_torch import resolve_device
from repro_torch.core.decision import (
    DecisionEngine,
    LeastPredictedWaitBalancer,
    MinLatencyPolicy,
    RoundRobinBalancer,
)
from repro_torch.core.fit import build_fleet_predictor, build_predictor, fit_app
from repro_torch.core.runtime import PlacementRuntime, TwinBackend
from repro_torch.core.workload import BurstyWorkload

CONFIGS = (1280, 1536, 1792, 2048)
DEVICES = {"edge0": 1.0, "edge1": 1.0, "edge2": 0.6}  # one slow straggler
C_MAX = 2e-6  # edge-first budget: bursts must be absorbed by the devices
N_INPUTS = 150
N_TASKS = 3000


def run(device=None, *, n_inputs: int = N_INPUTS, n_tasks: int = N_TASKS,
        log=None) -> dict:
    """Serve the bursty IR stream on one edge and on the 3-device fleet under
    both balancers; returns each result by the row name it prints (under
    ``"results"``) and the printed numbers (under ``"headline"``)."""
    dev = resolve_device(device)
    say = log or (lambda *_: None)

    say("fitting IR models...")
    twin, models = fit_app("IR", seed=0, n_inputs=n_inputs, configs=CONFIGS)
    tasks = BurstyWorkload(rate_per_s=4.0, size_sampler=twin.sample_input,
                           burst_multiplier=6.0, mean_quiet_s=15.0,
                           mean_burst_s=6.0, seed=7).generate(n_tasks)

    def fleet(balancer):
        pred = build_fleet_predictor(models, dict(DEVICES), configs=CONFIGS)
        eng = DecisionEngine(predictor=pred,
                             policy=MinLatencyPolicy(c_max=C_MAX, alpha=0.02),
                             balancer=balancer, device=dev)
        backend = TwinBackend(twin, seed=11, edge_names=tuple(DEVICES),
                              edge_speed=DEVICES)
        return PlacementRuntime(eng, backend).serve(tasks)

    def single():
        pred = build_predictor(models, configs=CONFIGS)
        eng = DecisionEngine(predictor=pred,
                             policy=MinLatencyPolicy(c_max=C_MAX, alpha=0.02),
                             device=dev)
        return PlacementRuntime(eng, TwinBackend(twin, seed=11)).serve(tasks)

    say(f"\n{'configuration':<24} {'mean s':>8} {'p99 s':>8} {'edge#':>6}")
    results = {}
    for name, serve in [
            ("single edge (paper)", single),
            ("fleet-3 round-robin", lambda: fleet(RoundRobinBalancer())),
            ("fleet-3 least-wait",
             lambda: fleet(LeastPredictedWaitBalancer()))]:
        res = serve()
        results[name] = res
        say(f"{name:<24} {res.avg_actual_latency_ms / 1e3:>8.1f} "
            f"{res.p99_actual_latency_ms / 1e3:>8.1f} {res.n_edge:>6d}")

    say("\nleast-wait fleet balance (note the slow device taking fewer "
        "tasks):")
    say(results["fleet-3 least-wait"].device_table())
    return {"results": results,
            "headline": {k: {"mean_s": r.avg_actual_latency_ms / 1e3,
                             "p99_s": r.p99_actual_latency_ms / 1e3,
                             "edge": r.n_edge}
                         for k, r in results.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    run(args.device, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
