"""The port's what-if capacity planner (``repro_torch.planner``) against the
JAX package's (``repro.planner``).

On the seeded 600-task STT fixture of ``tests/test_planner.py`` the port's
planner, replaying every candidate on the torch placement core
(``array_backend="torch", device="cpu"``), must return the reference's
winner and the reference's scores BIT-FOR-BIT — cost, attainment,
percentiles, makespan — in sequential, thread and spawn-process modes; the
same for successive halving (which must agree with grid search), for the
budget bisect, and for the port's own numpy route. Scoring arithmetic,
ranking and every validation error are the reference's too, and the
factories pickle (as a spawned child needs).
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

import repro.planner as ref_planner
import repro_torch.planner as port_planner
from repro.core.workload import PoissonWorkload as RefPoisson
from repro.planner.candidates import fitted as ref_fitted
from repro.trace import Trace as RefTrace
from repro_torch.core.records import SimulationResult, TaskRecord
from repro_torch.core.workload import TaskInput
from repro_torch.planner import (
    SLO,
    Candidate,
    Planner,
    PolicySpec,
    TwinRuntimeFactory,
    plan,
    score_candidate,
)
from repro_torch.planner.candidates import fitted
from repro_torch.planner.search import _rank_key
from repro_torch.trace import Trace, TraceError

CONFIGS = (1280, 1536, 1792, 2048)
CPU = {"device": "cpu"}


def _traces(app, rate, n):
    """The reference's fixture trace and the same columns as the port's."""
    twin, _ = ref_fitted(app, seed=0, n_inputs=120, configs=CONFIGS)
    tasks = RefPoisson(rate_per_s=rate, size_sampler=twin.sample_input,
                       seed=5).generate(n)
    ref = RefTrace.from_tasks(tasks, app=app)
    return ref, Trace.from_arrays(ref.arrival_ms, ref.size, ref.bytes,
                                  app_names=(app,))


@pytest.fixture(scope="module")
def stt():
    """600 STT arrivals at 0.12/s: one device saturates, two are stable."""
    return _traces("STT", 0.12, 600)


@pytest.fixture(scope="module")
def ir():
    """300 IR arrivals at 3/s on one device: c_max decides the offload."""
    return _traces("IR", 3.0, 300)


def _candidates(pkg=port_planner):
    pol = pkg.PolicySpec(kind="min_latency", c_max=0.0)
    return [pkg.Candidate.make(f"fleet-{k}", k, policy=pol,
                               cloud_configs=CONFIGS,
                               device_rate_per_hour=0.05) for k in (1, 2, 3)]


SLO_ARGS = dict(latency_ms=40_000.0, target=0.95)


def _planner(trace, **kw):
    return Planner(trace, SLO(**SLO_ARGS), fit_seed=0, n_inputs=120,
                   fit_configs=CONFIGS, **{**CPU, **kw})


def _ref_planner(trace, slo=None):
    return ref_planner.Planner(trace, slo or ref_planner.SLO(**SLO_ARGS),
                               fit_seed=0, n_inputs=120, fit_configs=CONFIGS)


def _key(s):
    return (s.candidate.name, s.n, s.cloud_cost, s.fleet_cost,
            s.mean_latency_ms, s.p50_latency_ms, s.p95_latency_ms,
            s.p99_latency_ms, s.attainment, s.meets_slo, s.makespan_ms,
            s.per_app_attainment, s.candidate.policy.c_max)


@pytest.fixture(scope="module")
def ref_grid(stt):
    return _ref_planner(stt[0]).plan(_candidates(ref_planner),
                                     strategy="grid", parallel=False)


# ------------------------------------------------------------- the fixture
@pytest.mark.parametrize("mode", [
    dict(parallel=False), dict(parallel=True),
    dict(parallel=True, use_processes=True)],
    ids=["sequential", "thread", "process"])
def test_plan_matches_reference_in_every_mode(stt, ref_grid, mode):
    res = _planner(stt[1]).plan(_candidates(), strategy="grid", **mode)
    assert res.mode == ("sequential" if not mode["parallel"] else
                        "process" if mode.get("use_processes") else "thread")
    assert res.best.candidate.name == ref_grid.best.candidate.name \
        == "fleet-2"
    assert res.best.meets_slo and res.best.n == stt[1].n
    assert [_key(s) for s in res.scores] == [_key(s) for s in ref_grid.scores]
    assert res.replayed_tasks == ref_grid.replayed_tasks == 3 * stt[1].n
    meeting = [s for s in res.scores if s.meets_slo]
    assert {s.candidate.name for s in meeting} == {"fleet-2", "fleet-3"}
    assert res.best.total_cost == min(s.total_cost for s in meeting)


def test_numpy_route_of_the_port_matches_torch_route(stt, ref_grid):
    res = _planner(stt[1], array_backend="numpy").plan(
        _candidates(), strategy="grid", parallel=False)
    assert [_key(s) for s in res.scores] == [_key(s) for s in ref_grid.scores]


def test_halving_matches_reference_and_grid(stt, ref_grid):
    kw = dict(strategy="halving", rungs=3, min_rung_n=100)
    planner = _planner(stt[1])
    assert planner.last_mode == "none"
    halv = planner.plan(_candidates(), **kw)
    ref = _ref_planner(stt[0]).plan(_candidates(ref_planner), **kw)
    assert halv.best.candidate.name == ref_grid.best.candidate.name
    assert halv.best.n == stt[1].n
    assert _key(halv.best) == _key(ref_grid.best) == _key(ref.best)
    assert [_key(s) for s in halv.scores] == [_key(s) for s in ref.scores]
    assert halv.rungs == ref.rungs
    assert all(len(r["kept"]) < len(r["evaluated"]) for r in halv.rungs)
    assert halv.replayed_tasks == ref.replayed_tasks < 3 * stt[1].n
    # each replay's per-shard stats: the rungs, then the full trace
    assert len(halv.stream_stats) == len(halv.rungs) + 1
    assert [{k.split("/")[0] for k in st} for st in halv.stream_stats] == \
        [set(r["evaluated"]) for r in halv.rungs] + \
        [{s.candidate.name for s in halv.scores}]
    assert sum(st["n"] for rung in halv.stream_stats
               for st in rung.values()) == halv.replayed_tasks
    assert all(st["launches"] == {} for rung in halv.stream_stats
               for st in rung.values())
    assert planner.last_mode == halv.mode == planner.last_sharded.mode


def test_plan_convenience_wrapper(stt):
    res = plan(stt[1], _candidates(), SLO(**SLO_ARGS), strategy="halving",
               rungs=2, min_rung_n=100, fit_configs=CONFIGS, n_inputs=120,
               **CPU)
    assert res.best.candidate.name == "fleet-2"
    assert res.strategy == "halving"
    assert "best: fleet-2" in res.table()


def test_no_candidate_meets_slo_returns_best_attainment(stt):
    res = Planner(stt[1], SLO(latency_ms=1.0, target=0.99), n_inputs=120,
                  fit_configs=CONFIGS, **CPU).plan(_candidates()[:2])
    ref = ref_planner.Planner(stt[0], ref_planner.SLO(1.0, 0.99),
                              n_inputs=120, fit_configs=CONFIGS).plan(
        _candidates(ref_planner)[:2])
    assert not res.best.meets_slo
    assert res.best.attainment == max(s.attainment for s in res.scores)
    assert [_key(s) for s in res.scores] == [_key(s) for s in ref.scores]


# ------------------------------------------------------------ budget bisect
def test_budget_bisect_matches_reference(ir):
    def cands(pkg):
        return [pkg.Candidate.make(
            "one-edge", 1, policy=pkg.PolicySpec(kind="min_latency",
                                                 c_max=2e-4),
            cloud_configs=CONFIGS, device_rate_per_hour=0.05)]

    slo = dict(latency_ms=2_000.0, target=0.9)
    planner = Planner(ir[1], SLO(**slo), fit_configs=CONFIGS, **CPU)
    base = planner.plan(cands(port_planner))
    res = planner.plan(cands(port_planner), budget_strategy="bisect",
                       budget_iters=6)
    ref = ref_planner.Planner(ir[0], ref_planner.SLO(**slo),
                              fit_configs=CONFIGS).plan(
        cands(ref_planner), budget_strategy="bisect", budget_iters=6)
    assert res.best.meets_slo
    assert res.best.candidate.policy.c_max < 2e-4
    assert res.best.candidate.name == "one-edge"
    assert res.best.total_cost <= base.best.total_cost
    assert _key(res.best) == _key(ref.best)
    probes = [r for r in res.rungs if "budget_probe" in r]
    assert probes == [r for r in ref.rungs if "budget_probe" in r]
    assert res.replayed_tasks == base.replayed_tasks * (1 + len(probes))
    assert len(base.stream_stats) == 1
    assert len(res.stream_stats) == 1 + len(probes)


def test_budget_bisect_leaves_min_cost_winner_alone(ir):
    pol = PolicySpec(kind="min_cost", deadline_ms=2_000.0)
    res = Planner(ir[1], SLO(latency_ms=2_000.0, target=0.9),
                  fit_configs=CONFIGS, **CPU).plan(
        [Candidate.make("mc", 1, policy=pol, cloud_configs=CONFIGS)],
        budget_strategy="bisect")
    assert not any("budget_probe" in r for r in res.rungs)
    assert res.best.candidate.policy.c_max == pol.c_max


# ------------------------------------------------------------------ scoring
def _fake_result(arrivals, completions, latencies, costs):
    recs = [TaskRecord(
        task=TaskInput(idx=i, arrival_ms=a, size=1.0, bytes=1.0),
        target="edge0", predicted_latency_ms=lat, predicted_cost=c,
        actual_latency_ms=lat, actual_cost=c, predicted_cold=False,
        actual_cold=False, allowed_cost=float("inf"), feasible=True,
        completion_ms=cm)
        for i, (a, cm, lat, c) in enumerate(
            zip(arrivals, completions, latencies, costs))]
    return SimulationResult(records=recs)


def test_score_candidate_arithmetic():
    cand = Candidate.make("c", {"edge0": 1.0, "edge1": 0.5},
                          device_rate_per_hour=0.10)
    res = _fake_result(arrivals=[0.0, 1000.0],
                       completions=[500.0, 1_800_000.0],
                       latencies=[100.0, 900.0], costs=[2e-6, 3e-6])
    s = score_candidate(cand, {"STT": res}, SLO(latency_ms=500.0, target=0.5))
    assert s.n == 2
    assert s.cloud_cost == pytest.approx(5e-6)
    assert s.fleet_cost == pytest.approx(0.075)
    assert s.total_cost == pytest.approx(0.075 + 5e-6)
    assert s.attainment == 0.5 and s.meets_slo
    assert s.per_app_attainment == {"STT": 0.5}
    assert s.makespan_ms == pytest.approx(1_800_000.0)


def test_ranking_prefers_meeting_then_cheapest():
    slo = SLO(latency_ms=500.0, target=0.9)
    cheap_missing = score_candidate(Candidate.make("x", 1), {"A": _fake_result(
        [0.0], [100.0], [1000.0], [1e-6])}, slo)
    costly_meeting = score_candidate(
        Candidate.make("y", 1, device_rate_per_hour=1.0), {"A": _fake_result(
            [0.0], [3_600_000.0], [100.0], [1e-6])}, slo)
    assert _rank_key(costly_meeting) < _rank_key(cheap_missing)


# --------------------------------------------------------------- validation
def test_candidate_and_policy_validation():
    with pytest.raises(ValueError, match="unknown policy kind"):
        PolicySpec(kind="yolo")
    with pytest.raises(ValueError, match="empty fleet"):
        Candidate(name="c", fleet=())
    with pytest.raises(ValueError, match="duplicate fleet devices"):
        Candidate(name="c", fleet=(("e0", 1.0), ("e0", 2.0)))
    with pytest.raises(ValueError, match="count must be >= 1"):
        Candidate.make("c", 0)
    with pytest.raises(ValueError, match="chunk_size"):
        Candidate(name="c", fleet=(("e0", 1.0),), chunk_size=0)
    assert Candidate.make("c", 2).fleet == (("edge0", 1.0), ("edge1", 1.0))
    assert PolicySpec(kind="min_cost",
                      deadline_ms=5.0).build().deadline_ms == 5.0
    assert PolicySpec(kind="hedged", c_max=1e-5,
                      hedge_threshold_ms=100.0).build().hedge_threshold_ms \
        == 100.0


def test_slo_validation():
    with pytest.raises(ValueError, match="target"):
        SLO(latency_ms=100.0, target=0.0)
    with pytest.raises(ValueError, match="latency"):
        SLO(latency_ms=0.0)


def test_planner_rejects_bad_inputs(stt):
    planner = _planner(stt[1])
    with pytest.raises(ValueError, match="duplicate candidate names"):
        planner.evaluate([Candidate.make("a", 1), Candidate.make("a", 2)])
    with pytest.raises(ValueError, match="no candidates"):
        planner.evaluate([])
    with pytest.raises(ValueError, match="unknown strategy"):
        planner.plan(_candidates(), strategy="bogus")
    with pytest.raises(ValueError, match="budget_strategy"):
        planner.plan(_candidates(), budget_strategy="newton")
    with pytest.raises(TraceError, match="empty trace"):
        Planner(Trace.from_arrays([], [], [], app_names=("STT",)),
                SLO(latency_ms=1.0), **CPU)
    with pytest.raises(TraceError, match="not a known application"):
        Planner(Trace.from_arrays([0.0], [1.0], [1.0],
                                  app_names=("mystery",)),
                SLO(latency_ms=1.0), **CPU)
    with pytest.raises(ValueError, match="device must be"):
        Planner(stt[1], SLO(latency_ms=1.0), device="meta")


def test_unknown_app_in_fit_cache():
    with pytest.raises(ValueError, match="unknown app 'nope'"):
        fitted("nope")


def test_fits_match_the_reference():
    """The planner's fit cache fits what the reference's does, bit for bit
    (the cross-package score parity rests on it)."""
    twin, models = fitted("STT", seed=0, n_inputs=120, configs=CONFIGS)
    _, ref_models = ref_fitted("STT", seed=0, n_inputs=120, configs=CONFIGS)
    assert fitted("STT", seed=0, n_inputs=120, configs=CONFIGS)[1] is models
    for k in ("features", "thresholds", "leaves"):
        assert np.array_equal(np.asarray(getattr(models.comp_cloud, k)),
                              np.asarray(getattr(ref_models.comp_cloud, k)))
    assert np.array_equal(models.upld.theta, np.asarray(ref_models.upld.theta))


def test_factory_pickles_with_its_device_as_a_string():
    f = TwinRuntimeFactory(app="IR", candidate=Candidate.make("c", 1),
                           fit_configs=CONFIGS, device="cpu",
                           array_backend="numpy")
    back = pickle.loads(pickle.dumps(f))
    assert back == f and isinstance(back.device, str)
    rt = back()
    assert rt.engine.array_backend == "numpy"
    assert str(rt.engine.device) == "cpu"
    assert TwinRuntimeFactory(app="IR", candidate=Candidate.make("c", 1),
                              device="cpu")().engine.array_backend == "torch"
