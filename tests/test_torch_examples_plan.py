"""The port's ``examples/plan_capacity_torch.py`` against the JAX package's
``examples/plan_capacity.py``, on the CPU (apart from
``test_torch_examples.py``, so that a worker per file spreads the load).

The reference script is module-level code: the case rebuilds it from
``repro`` calls at the reference's sizes and seeds (20,000 STT arrivals in
8,192-task chunks, 8 candidates, a 3-rung halving search) and holds the
port's ``run(device="cpu")`` to it: the recorded stream, its trace and the
replay BIT-IDENTICAL per record; the search's rungs, the best candidate and
every score of the final ranking equal (tolerance none). The port's search
runs on one worker thread here: on the CPU the torch core's plain walk and
replay are Python loops over rows, which eight threads only make wait on
one another; the scores do not depend on the mode.
"""

from __future__ import annotations

import numpy as np

from repro.core.decision import DecisionEngine, MinLatencyPolicy
from repro.core.fit import build_fleet_predictor, fit_app
from repro.core.runtime import PlacementRuntime, TwinBackend
from repro.planner import SLO, Candidate, Planner, PolicySpec
from repro.trace import TraceWorkload, capture
from test_torch_examples import example

CONFIGS = (1280, 1536, 1792, 2048)
N, CHUNK = 20_000, 8_192

SCORE_FIELDS = ("n", "total_cost", "cloud_cost", "fleet_cost",
                "mean_latency_ms", "p50_latency_ms", "p95_latency_ms",
                "p99_latency_ms", "attainment", "meets_slo", "makespan_ms",
                "per_app_attainment")


def ref_plan_capacity():
    twin, models = fit_app("STT", seed=0, n_inputs=120, configs=CONFIGS)

    def make_runtime(fleet, c_max=0.0):
        pred = build_fleet_predictor(models, dict(fleet), configs=CONFIGS)
        eng = DecisionEngine(predictor=pred,
                             policy=MinLatencyPolicy(c_max=c_max, alpha=0.0))
        return PlacementRuntime(eng, TwinBackend(
            twin, seed=11, edge_names=tuple(fleet), edge_speed=fleet))

    fleet0 = {"edge0": 1.0, "edge1": 1.0}
    recorded = make_runtime(fleet0).serve_stream(
        twin.poisson(seed=3).chunks(N, CHUNK), chunk_size=CHUNK,
        keep_tasks=False, keep_inputs=True)
    trace = capture(recorded, app="STT")
    replay = make_runtime(fleet0).serve_stream(
        TraceWorkload(trace).chunks(chunk_size=CHUNK), chunk_size=CHUNK)
    edge_only = PolicySpec(kind="min_latency", c_max=0.0)
    with_cloud = PolicySpec(kind="min_latency", c_max=2.97e-5, alpha=0.02)
    candidates = [
        Candidate.make(f"fleet-{k}-{tag}", k, policy=pol,
                       cloud_configs=CONFIGS, chunk_size=CHUNK,
                       device_rate_per_hour=0.05)
        for k in (1, 2, 3, 4)
        for tag, pol in (("edge", edge_only), ("mixed", with_cloud))]
    planner = Planner(trace, SLO(latency_ms=40_000.0, target=0.95),
                      fit_seed=0, n_inputs=120, fit_configs=CONFIGS)
    result = planner.plan(candidates, strategy="halving", rungs=3,
                          min_rung_n=2_048)
    return {"recorded": recorded, "replay": replay, "trace": trace,
            "plan": result}


def test_plan_capacity_matches_reference():
    got = example("plan_capacity").run(device="cpu", max_workers=1)
    ref = ref_plan_capacity()
    for k in ("recorded", "replay"):
        a, b = got[k].records, ref[k].records
        assert list(a.targets) == list(b.targets), k
        for col in ("actual_latency_ms", "completion_ms", "actual_cost",
                    "predicted_latency_ms", "predicted_cost", "arrival_ms"):
            assert np.array_equal(getattr(a, col), getattr(b, col)), (k, col)
    assert np.array_equal(got["replay"].records.actual_latency_ms,
                          got["recorded"].records.actual_latency_ms)
    t, t0 = got["trace"], ref["trace"]
    assert t.n == t0.n == N
    assert np.array_equal(t.observed_latency_ms, t0.observed_latency_ms)
    assert t.duration_ms == t0.duration_ms

    plan, plan0 = got["plan"], ref["plan"]
    assert plan.replayed_tasks == plan0.replayed_tasks
    assert plan.rungs == plan0.rungs
    assert plan.mode == plan0.mode == "thread"
    assert plan.best.candidate.name == plan0.best.candidate.name \
        == "fleet-1-mixed"
    assert dict(plan.best.candidate.fleet) == dict(plan0.best.candidate.fleet)
    assert [s.candidate.name for s in plan.scores] == \
        [s.candidate.name for s in plan0.scores]
    for s, s0 in zip(plan.scores, plan0.scores):
        for f in SCORE_FIELDS:
            assert getattr(s, f) == getattr(s0, f), (s.candidate.name, f)
    assert plan.table() == plan0.table()
