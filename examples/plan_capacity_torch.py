"""Trace-driven capacity planning on the PyTorch port: record traffic,
replay what-ifs, pick the cheapest configuration that meets the SLO.

The counterpart of ``examples/plan_capacity.py``, through ``repro_torch``
only, on the CUDA card by default (the record and replay streams predict
through the GBRT kernel K2 on their 8,192-row chunks; the planner's
candidates place on the torch core). The workflow an operator actually
runs:

1. **Record** a day of traffic — here by capturing a served run of the STT
   smart-speaker workload into a ``Trace`` (in production the trace would
   come from the platform's request log) and round-tripping it through disk
   to show the format is bit-exact;
2. **Replay** it: a ``TraceWorkload`` streamed through ``serve_stream`` is
   bit-identical per record to serving the original in-memory workload;
3. **Plan**: replay the trace against 8 candidate configurations (fleet
   sizes 1–4 × edge-only vs cloud-budget policies) with successive halving,
   and report the cheapest candidate that serves the trace within SLO —
   verified on the full trace, never extrapolated from a prefix.

    PYTHONPATH=src python examples/plan_capacity_torch.py
    PYTHONPATH=src python examples/plan_capacity_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.decision import DecisionEngine, MinLatencyPolicy
from repro_torch.core.fit import build_fleet_predictor, fit_app
from repro_torch.core.runtime import PlacementRuntime, TwinBackend
from repro_torch.planner import SLO, Candidate, Planner, PolicySpec
from repro_torch.trace import TraceWorkload, capture, load

CONFIGS = (1280, 1536, 1792, 2048)
N = 20_000
CHUNK = 8_192


def run(device=None, *, n: int = N, chunk: int = CHUNK,
        max_workers: int | None = None, log=None) -> dict:
    """Record, round-trip and replay the STT stream, then the halving search
    over 8 candidates in threads (``max_workers`` of them; ``None``: one per
    candidate); returns the recorded run, its replay, the trace, the
    plan's result and, under ``"headline"``, the printed numbers."""
    dev = resolve_device(device)
    say = log or (lambda *_: None)
    twin, models = fit_app("STT", seed=0, n_inputs=120, configs=CONFIGS)

    def make_runtime(fleet: dict[str, float], c_max: float = 0.0):
        pred = build_fleet_predictor(models, dict(fleet), configs=CONFIGS)
        eng = DecisionEngine(predictor=pred,
                             policy=MinLatencyPolicy(c_max=c_max, alpha=0.0),
                             device=dev)
        return PlacementRuntime(eng, TwinBackend(
            twin, seed=11, edge_names=tuple(fleet), edge_speed=fleet))

    # ------------------------------------------------------------ 1. record
    fleet0 = {"edge0": 1.0, "edge1": 1.0}
    recorded = make_runtime(fleet0).serve_stream(
        twin.poisson(seed=3).chunks(n, chunk), chunk_size=chunk,
        keep_tasks=False, keep_inputs=True)  # constant-memory, capturable
    trace = capture(recorded, app="STT")

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "stt_day.jsonl"
        trace.save(path)                      # JSONL: greppable, appendable
        trace = load(path)                    # validated + bit-exact reload
    say(f"recorded {trace.n:,} arrivals over "
        f"{trace.duration_ms / 3.6e6:.1f} h (observed p99 "
        f"{np.percentile(trace.observed_latency_ms, 99):,.0f} ms)")

    # ------------------------------------------------------------ 2. replay
    replay = make_runtime(fleet0).serve_stream(
        TraceWorkload(trace).chunks(chunk_size=chunk), chunk_size=chunk)
    assert np.array_equal(replay.records.actual_latency_ms,
                          recorded.records.actual_latency_ms)
    say("replay is bit-identical to the recorded run "
        f"(mean {replay.avg_actual_latency_ms:,.0f} ms)")

    # -------------------------------------------------------------- 3. plan
    edge_only = PolicySpec(kind="min_latency", c_max=0.0)
    with_cloud = PolicySpec(kind="min_latency", c_max=2.97e-5, alpha=0.02)
    candidates = [
        Candidate.make(f"fleet-{k}-{tag}", k, policy=pol,
                       cloud_configs=CONFIGS, chunk_size=chunk,
                       device_rate_per_hour=0.05)
        for k in (1, 2, 3, 4)
        for tag, pol in (("edge", edge_only), ("mixed", with_cloud))]

    slo = SLO(latency_ms=40_000.0, target=0.95)
    planner = Planner(trace, slo, fit_seed=0, n_inputs=120,
                      fit_configs=CONFIGS, max_workers=max_workers,
                      device=str(dev))
    t0 = time.perf_counter()
    result = planner.plan(candidates, strategy="halving", rungs=3,
                          min_rung_n=2_048)
    dt = time.perf_counter() - t0

    say(f"\nwhat-if search: {len(candidates)} candidates, "
        f"{result.replayed_tasks:,} task-replays in {dt:.1f}s "
        f"({result.mode})")
    for rung in result.rungs:
        say(f"  rung {rung['rung']} @ {rung['prefix_n']:,} tasks: "
            f"kept {rung['kept']}")
    say(result.table())
    best = result.best
    say(f"\n=> provision {dict(best.candidate.fleet)} with the "
        f"{best.candidate.policy.kind} policy: ${best.total_cost:.4f} total, "
        f"{best.attainment:.2%} of tasks within {slo.latency_ms / 1e3:.0f} s")
    best = result.best
    return {"recorded": recorded, "replay": replay, "trace": trace,
            "plan": result, "plan_s": dt,
            "headline": {"best": best.candidate.name,
                         "cost": best.total_cost,
                         "attainment": best.attainment,
                         "replayed_tasks": result.replayed_tasks,
                         "plan_s": dt, "mode": result.mode}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    run(args.device, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
