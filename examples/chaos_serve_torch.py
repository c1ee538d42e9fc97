"""Chaos twin on the PyTorch port: serve through a device outage with
retry, failover, and SLO-tiered load shedding — deterministically.

The counterpart of ``examples/chaos_serve.py``, through ``repro_torch``
only, on the CUDA card by default. The scenario an operator plans for:

1. **Baseline** — the FD workload on a 3-device fleet, no faults, tasks
   split into two SLO tiers (interactive / batch). Everything meets SLO.
2. **Chaos** — the SAME workload, but a declarative ``FaultSpec`` takes one
   edge device down for the middle 30% of the run and makes one cloud
   config flaky (15% transient dispatch errors). The failure-aware runtime
   retries transients with exponential backoff, fails crashed work over to
   the next-best surviving target (re-entering the real placement path with
   the dead target masked), trips a circuit breaker on consecutive
   failures, and sheds batch-tier work when predicted latency blows the
   tier deadline — so the interactive tier still meets its SLO.
3. **Determinism** — the fault schedule is a counter-based pure function of
   (spec, dispatch times): the same seed reproduces the identical
   retry/failover/shed set, and the spec rides inside a captured trace
   (``fault_spec_of``) so any chaos run is replayable.
4. **Overload survival** — a 20x MMPP arrival burst. Reactively, the burst
   front eats a cold-start storm (the warm pool matches the quiet-phase
   rate). With ``PrewarmPolicy`` the streaming burst forecaster spots the
   regime switch a few arrivals in and spawns keep-alive containers ahead
   of the front, visibly cutting cold starts; with ``ReclamationPolicy``
   the same burst pressuring the top tier preempts placed lower-tier work
   off the hot device (demoting it one SLO class) instead of only shedding
   new arrivals at the admission door.

    PYTHONPATH=src python examples/chaos_serve_torch.py
    PYTHONPATH=src python examples/chaos_serve_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.decision import (
    DecisionEngine,
    MinCostPolicy,
    MinLatencyPolicy,
)
from repro_torch.core.faults import (
    AdmissionPolicy,
    CircuitBreaker,
    FaultSpec,
    OutageWindow,
    RetryPolicy,
    SLOTier,
    TransientErrors,
)
from repro_torch.core.fit import build_fleet_predictor, fit_app
from repro_torch.core.overload import PrewarmPolicy, ReclamationPolicy
from repro_torch.core.runtime import PlacementRuntime, TwinBackend
from repro_torch.core.workload import BurstyWorkload
from repro_torch.trace import capture, fault_spec_of

CONFIGS = (1280, 1536, 1792)
FLEET = {"edge0": 1.0, "edge1": 1.0, "edge2": 0.6}
N = 2_000
N_BURST = 400
INTERACTIVE_SLO_MS = 15_000.0
BATCH_SLO_MS = 2_400.0          # tight: admission sheds batch work over it


def run(device=None, *, n: int = N, n_burst: int = N_BURST,
        log=None) -> dict:
    """The baseline, the chaos run and its rerun, the captured trace, the
    burst served reactively, with pre-warming and with reclamation; returns
    each result, the runtimes (their breaker, prewarm and reclaim logs) and
    the printed numbers (also under ``"headline"``)."""
    dev = resolve_device(device)
    say = log or (lambda *_: None)

    twin, models = fit_app("FD", seed=0, n_inputs=120, configs=CONFIGS)
    tasks = twin.workload(n, seed=3)
    for t in tasks:
        t.tier = 0 if t.idx % 4 else 1     # 75% interactive, 25% batch
    span = tasks[-1].arrival_ms
    tiers = (SLOTier(INTERACTIVE_SLO_MS, sheddable=False),   # never shed
             SLOTier(BATCH_SLO_MS))                          # sheddable

    def make_runtime(faults=None, failure_aware=False, policy=None,
                     **overload):
        pred = build_fleet_predictor(models, dict(FLEET), configs=CONFIGS)
        eng = DecisionEngine(predictor=pred, policy=policy or MinLatencyPolicy(
            c_max=2.97e-5, alpha=0.02), device=dev)
        backend = TwinBackend(twin, seed=11, edge_names=tuple(FLEET),
                              edge_speed=FLEET, faults=faults)
        if not failure_aware:
            return PlacementRuntime(eng, backend, **overload)
        return PlacementRuntime(
            eng, backend,
            retry=RetryPolicy(max_attempts=4, backoff_ms=50.0,
                              backoff_mult=2.0),
            breaker=CircuitBreaker(threshold=3, probation_ms=30_000.0),
            admission=AdmissionPolicy(tiers=tiers, headroom=1.0))

    def report(tag, res):
        say(f"{tag:>9}: interactive SLO "
            f"{res.slo_attainment(INTERACTIVE_SLO_MS, tier=0):6.2%}   "
            f"batch SLO {res.slo_attainment(BATCH_SLO_MS, tier=1):6.2%}   "
            f"retried {res.n_retried:3d}  failed {res.n_failed}  "
            f"shed {res.n_shed}")

    # ----------------------------------------------------------- 1. baseline
    base = make_runtime().serve(tasks)
    report("baseline", base)

    # -------------------------------------------------------------- 2. chaos
    spec = FaultSpec(
        seed=7,
        outages=[OutageWindow("edge1", 0.35 * span, 0.65 * span)],  # mid-run
        transient=[TransientErrors("1792", 0.15)],
    )
    rt = make_runtime(faults=spec, failure_aware=True)
    chaos = rt.serve(tasks)
    report("chaos", chaos)
    assert chaos.slo_attainment(INTERACTIVE_SLO_MS, tier=0) >= 0.99, \
        "the interactive tier must ride through the outage"
    say(f"           circuit breaker opened {rt.health.n_opens}x; "
        f"{(chaos.records.attempts > 1).sum()} tasks re-dispatched "
        f"(max {chaos.records.attempts.max()} attempts)")

    # ------------------------------------------------------ 3. deterministic
    again = make_runtime(faults=spec, failure_aware=True).serve(tasks)
    assert np.array_equal(chaos.records.actual_latency_ms,
                          again.records.actual_latency_ms)
    assert np.array_equal(chaos.records.attempts, again.records.attempts)
    assert np.array_equal(chaos.records.shed, again.records.shed)
    say("rerun with the same spec: identical fault schedule, retries, and "
        "shed set")

    trace = capture(chaos, app="FD", faults=spec)
    assert fault_spec_of(trace) == spec
    say("fault spec rides inside the captured trace — chaos runs replay")

    # -------------------------------------------- 4a. burst: predictive prewarm
    burst_wl = BurstyWorkload(rate_per_s=2.0, size_sampler=twin.sample_input,
                              burst_multiplier=20.0, mean_quiet_s=20.0,
                              mean_burst_s=5.0, seed=3)
    burst_tasks = burst_wl.generate(n_burst)
    reactive = make_runtime().serve(burst_tasks)
    rt_pw = make_runtime(prewarm=PrewarmPolicy(count=4))
    warmed = rt_pw.serve(burst_tasks)
    cold_re = int(reactive.records.actual_cold.sum())
    cold_pw = int(warmed.records.actual_cold.sum())
    say(f"\n20x burst, reactive: {cold_re} cold starts; predictive prewarm: "
        f"{cold_pw} ({rt_pw.overload.forecaster.n_triggers} burst(s) "
        f"forecast, {len(rt_pw.overload.prewarm_log)} containers spawned, "
        f"{rt_pw.overload.n_extensions} keep-alive extensions)")
    assert cold_pw < cold_re, "pre-warming must beat reacting to the burst"

    # ----------------------------------------- 4b. burst: fair-share reclaim
    for i, t in enumerate(burst_tasks):
        t.tier = i % 3              # interactive / standard / batch
    recl = ReclamationPolicy(tiers=(SLOTier(3_000.0, sheddable=False),
                                    SLOTier(2_500.0), SLOTier(2_000.0)),
                             shares=(2.0, 1.0, 1.0))
    rt_rc = make_runtime(policy=MinCostPolicy(deadline_ms=3_000.0),
                         reclamation=recl)
    reclaimed = rt_rc.serve(burst_tasks)
    n_moved = sum(1 for e in rt_rc.overload.reclaim_log if e[6])
    say(f"under tier-0 pressure: {len(rt_rc.overload.reclaim_log)} lower-tier "
        f"tasks preempted ({n_moved} moved off the hot device, "
        f"{reclaimed.n_downgraded} demoted one SLO class, 0 shed)")
    assert len(rt_rc.overload.reclaim_log) > 0
    headline = {"interactive_slo": chaos.slo_attainment(INTERACTIVE_SLO_MS,
                                                        tier=0),
                "breaker_opens": rt.health.n_opens,
                "cold_reactive": cold_re, "cold_prewarmed": cold_pw,
                "reclaims": len(rt_rc.overload.reclaim_log)}
    return {"baseline": base, "chaos": chaos, "again": again, "trace": trace,
            "chaos_runtime": rt, "reactive": reactive, "prewarmed": warmed,
            "prewarm_runtime": rt_pw, "reclaimed": reclaimed,
            "reclaim_runtime": rt_rc, **headline, "headline": headline}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    run(args.device, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
