"""The port's other serve paths on the torch placement core, and its shards.

Every case runs the same path twice on the same seeds: the JAX package's
numpy route (``repro``, the oracle) and the port on ``array_backend="torch",
device="cpu"``; the records must be BIT-IDENTICAL — every float column, every
target, the failure and overload columns — and so must the fault, prewarm
and reclamation schedules. The cases are the reference's cross-path tests,
each also on the torch engine:

- ``serve(batched=True)`` and ``serve_async`` (``tests/test_events.py``),
  MinCost / MinLatency / Hedged on 1- and 3-device fleets;
- failure-aware serving over an empty and a faulted ``FaultSpec``
  (``tests/test_faults.py``) on ``serve``, ``serve_async``, ``serve_stream``;
- overload pre-warming and tier reclamation, armed-but-idle and firing
  (``tests/test_overload.py``);
- ``serve_stream`` against one-shot ``serve``, the hedged fallback and an
  unsorted stream (``tests/test_streaming.py``);
- ``ShardedRuntime`` in sequential, thread and spawn-process modes, against
  the reference's shards, with each shard's kernel launches tallied;
- the deprecated ``Simulation`` wrapper.

Each case also asserts the port engine's ``fallback_chunks``: the chunks that
left the device route for the numpy path. Paper policies stay on the route
(0); a hedged policy leaves it once per ``place_many`` call; an unsorted
stream leaves it for every chunk from the first disorder on. Tolerance: none.
"""

from __future__ import annotations

import multiprocessing
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.decision as _rd
import repro.core.faults as _rf
import repro.core.fit as _rfit
import repro.core.overload as _ro
import repro.core.runtime as _rr
import repro.core.simulator as _rs
import repro.core.workload as _rw
import repro_torch.core.decision as _pd
import repro_torch.core.faults as _pf
import repro_torch.core.fit as _pfit
import repro_torch.core.overload as _po
import repro_torch.core.runtime as _pr
import repro_torch.core.simulator as _ps
import repro_torch.core.workload as _pw
from repro.core.multiapp import AppShard as RefShard
from repro.core.multiapp import ShardedRuntime as RefSharded
from repro_torch import kernels
from repro_torch.core import multiapp
from repro_torch.core.multiapp import AppShard, ShardedRuntime, serve_sharded
from repro_torch.planner import Candidate, PolicySpec, TwinRuntimeFactory
from repro_torch.trace import Trace, TraceChunkFactory

CONFIGS = (1280, 1536, 1792)
FLEET3 = {"edge0": 1.0, "edge1": 1.0, "edge2": 0.6}
FLEET1 = {"edge0": 1.0}

FLOAT_COLS = ("predicted_latency_ms", "predicted_cost", "actual_latency_ms",
              "actual_cost", "allowed_cost", "completion_ms", "queue_wait_ms",
              "exec_ms", "hedge_exec_ms", "arrival_ms")
OTHER_COLS = ("predicted_cold", "actual_cold", "feasible", "hedged",
              "attempts", "failed", "shed", "tier", "downgraded")


def _pkg(ref: bool) -> SimpleNamespace:
    d, f, fit, o, r, w = ((_rd, _rf, _rfit, _ro, _rr, _rw) if ref
                          else (_pd, _pf, _pfit, _po, _pr, _pw))
    return SimpleNamespace(
        ref=ref, d=d, f=f, fit=fit, o=o, r=r, w=w,
        engine_kw={} if ref else {"array_backend": "torch", "device": "cpu"})


REF, PORT = _pkg(True), _pkg(False)


@pytest.fixture(scope="module")
def fd():
    """FD fitted by each package on the same seeds."""
    return {p.ref: p.fit.fit_app("FD", seed=0, n_inputs=120, configs=CONFIGS)
            for p in (REF, PORT)}


POLICIES = {
    "mincost": lambda p: p.d.MinCostPolicy(deadline_ms=4500.0),
    "minlat": lambda p: p.d.MinLatencyPolicy(c_max=2.97e-5, alpha=0.02),
    "hedged": lambda p: p.d.HedgedPolicy(
        p.d.MinLatencyPolicy(c_max=8e-5, alpha=0.0),
        hedge_threshold_ms=1500.0),
}


def _runtime(p, setups, fleet=FLEET3, policy="minlat", seed=11, faults=None,
             **knobs):
    twin, models = setups[p.ref]
    if fleet:
        pred = p.fit.build_fleet_predictor(models, dict(fleet),
                                           configs=CONFIGS)
        backend = p.r.TwinBackend(twin, seed=seed, edge_names=tuple(fleet),
                                  edge_speed=dict(fleet), faults=faults)
    else:
        pred = p.fit.build_predictor(models, configs=CONFIGS)
        backend = p.r.TwinBackend(twin, seed=seed, faults=faults)
    pol = POLICIES[policy](p) if isinstance(policy, str) else policy(p)
    eng = p.d.DecisionEngine(predictor=pred, policy=pol, **p.engine_kw)
    return p.r.PlacementRuntime(eng, backend, **knobs)


def _tasks(p, setups, n, seed):
    return setups[p.ref][0].workload(n, seed=seed)


def _same_tasks(setups, n, seed):
    ref, port = _tasks(REF, setups, n, seed), _tasks(PORT, setups, n, seed)
    assert [(t.arrival_ms, t.size, t.bytes) for t in ref] == \
        [(t.arrival_ms, t.size, t.bytes) for t in port]
    return ref, port


def assert_same(a, b):
    """Bit-identical records (``a``, ``b``: results or record batches)."""
    ra = getattr(a, "records", a)
    rb = getattr(b, "records", b)
    assert len(ra) == len(rb)
    assert list(ra.targets) == list(rb.targets)
    for col in FLOAT_COLS + OTHER_COLS:
        x, y = getattr(ra, col), getattr(rb, col)
        if x is None or y is None:
            assert x is None and y is None, col
            continue
        assert np.array_equal(np.asarray(x), np.asarray(y)), col
    assert [int(c) for c in ra.hedge_codes] == [int(c) for c in rb.hedge_codes]


def _summaries(res) -> dict:
    return {d: vars(s) for d, s in res.device_summaries().items()}


def _both(setups, run, n=150, task_seed=2, **kw):
    """``run(runtime, tasks)`` on the reference and on the port; returns
    ``(ref result, port result, port runtime)`` after checking parity."""
    ref_tasks, tasks = _same_tasks(setups, n, task_seed)
    ref = run(_runtime(REF, setups, **kw), ref_tasks)
    rt = _runtime(PORT, setups, **kw)
    got = run(rt, tasks)
    assert_same(got, ref)
    return ref, got, rt


# -------------------------------------------------- serve and serve_async
@pytest.mark.parametrize("fleet", [{}, FLEET3], ids=["1-device", "3-device"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_serve_and_serve_async_match_reference(fd, policy, fleet):
    """``tests/test_events.py:171`` on the torch engine: ``serve`` and
    ``serve_async`` are each bit-identical to the reference's, and to each
    other. A paper policy stays on the device route; a hedged one leaves
    it for its one ``place_many`` call."""
    ref, a, rt_a = _both(fd, lambda rt, ts: rt.serve(ts), n=250,
                         task_seed=3, fleet=fleet, policy=policy, seed=17)
    _, b, rt_b = _both(fd, lambda rt, ts: rt.serve_async(ts), n=250,
                       task_seed=3, fleet=fleet, policy=policy, seed=17)
    assert_same(a, b)
    assert a.total_actual_cost == ref.total_actual_cost
    assert _summaries(a) == _summaries(b) == _summaries(ref)
    fallbacks = 1 if policy == "hedged" else 0
    assert rt_a.engine.fallback_chunks == rt_b.engine.fallback_chunks \
        == fallbacks
    if policy == "hedged":
        assert a.records.hedged.any(), "scenario must hedge"
    else:
        assert rt_a.engine.torch_stats["device"] == "cpu"


def test_execute_async_matches_execute_many_on_torch_decisions(fd):
    """``tests/test_events.py:124``: the event runner reproduces the batched
    sampler, outcomes and end state, for decisions the torch core made."""
    twin, models = fd[False]
    tasks = twin.workload(600, seed=2)
    eng = _pd.DecisionEngine(
        predictor=_pfit.build_fleet_predictor(models, FLEET3,
                                              configs=CONFIGS),
        policy=_pd.MinLatencyPolicy(c_max=1e-5, alpha=0.02),
        array_backend="torch", device="cpu")
    targets = eng.place_many(tasks).target_list()
    assert eng.fallback_chunks == 0
    assert set(targets) & set(FLEET3) and set(targets) - set(FLEET3)
    ref_twin, ref_models = fd[True]
    ref_eng = _rd.DecisionEngine(
        predictor=_rfit.build_fleet_predictor(ref_models, FLEET3,
                                              configs=CONFIGS),
        policy=_rd.MinLatencyPolicy(c_max=1e-5, alpha=0.02))
    assert ref_eng.place_many(ref_twin.workload(600, seed=2)).target_list() \
        == targets
    mk = lambda: _pr.TwinBackend(twin, seed=11, edge_names=tuple(FLEET3),  # noqa: E731
                                 edge_speed=FLEET3)
    b_many, b_evts = mk(), mk()
    a = b_many.execute_many(tasks, targets)
    b = b_evts.execute_async(tasks, targets)
    for f in ("latency_ms", "cost", "cold", "completion_ms", "queue_wait_ms",
              "exec_ms"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert b_many.edge_free_at == b_evts.edge_free_at


# ------------------------------------------------------------------ faults
def _fault_knobs(p):
    return dict(faults=p.f.FaultSpec(), retry=p.f.RetryPolicy(),
                breaker=p.f.CircuitBreaker(),
                admission=p.f.AdmissionPolicy(tiers=(p.f.SLOTier(1e12),)))


@pytest.mark.parametrize("fleet", [FLEET1, FLEET3], ids=["1dev", "3dev"])
@pytest.mark.parametrize("policy", ["minlat", "mincost"])
def test_empty_fault_spec_all_paths(fd, fleet, policy):
    """``tests/test_faults.py:177``: retry, breaker and admission over an
    EMPTY spec are bit-identical to the plain runtime on every serve path —
    here on the torch engine, against the reference's plain serve."""
    ref_tasks, tasks = _same_tasks(fd, 150, 2)
    plain = _runtime(REF, fd, fleet, policy).serve(ref_tasks)
    runs = [("serve", lambda rt: rt.serve(tasks)),
            ("serve_async", lambda rt: rt.serve_async(tasks))]
    runs += [(f"stream{cs}", lambda rt, cs=cs: rt.serve_stream(
        tasks, chunk_size=cs)) for cs in (1, 37, 150)]
    for name, run in runs:
        rt = _runtime(PORT, fd, fleet, policy, **_fault_knobs(PORT))
        assert_same(run(rt), plain)
        assert rt.engine.fallback_chunks == 0, name


def _chaos(p):
    return p.f.FaultSpec(
        seed=5, outages=[p.f.OutageWindow("1792", 10_000.0, 40_000.0)],
        transient=[p.f.TransientErrors("1536", 0.15)],
        stragglers=[p.f.Straggler("edge2", 0.0, 50_000.0, 3.0)],
        blackouts=[p.f.Blackout("iot", 20_000.0, 30_000.0)])


def test_faulted_run_identical_across_paths(fd):
    """``tests/test_faults.py:432`` on the torch engine: one fault schedule,
    retries and failovers included, on ``serve``, ``serve_async`` and a
    one-chunk ``serve_stream``, each bit-identical to the reference's
    ``serve``; a stream of 41-task chunks (whose breaker state meets chunk
    boundaries) is held to the reference's stream of the same chunks."""
    def mk(p):
        return _runtime(p, fd, FLEET3, faults=_chaos(p),
                        retry=p.f.RetryPolicy(max_attempts=4,
                                              backoff_ms=25.0),
                        breaker=p.f.CircuitBreaker(threshold=3))

    ref_tasks, tasks = _same_tasks(fd, 150, 10)
    base = mk(REF).serve(ref_tasks)
    assert base.n_retried > 0
    chunked = mk(REF).serve_stream(ref_tasks, chunk_size=41)
    for run, ref in ((lambda rt: rt.serve(tasks), base),
                     (lambda rt: rt.serve_async(tasks), base),
                     (lambda rt: rt.serve_stream(tasks,
                                                 chunk_size=len(tasks)), base),
                     (lambda rt: rt.serve_stream(tasks, chunk_size=41),
                      chunked)):
        rt = mk(PORT)
        got = run(rt)
        assert_same(got, ref)
        assert got.n_retried == ref.n_retried
        assert rt.engine.fallback_chunks == 0


# ---------------------------------------------------------------- overload
def _bursty(p, setups, n=400, seed=3, n_tiers=0):
    wl = p.w.BurstyWorkload(rate_per_s=2.0,
                            size_sampler=setups[p.ref][0].sample_input,
                            burst_multiplier=20.0, mean_quiet_s=20.0,
                            mean_burst_s=5.0, seed=seed)
    tasks = wl.generate(n)
    for i, t in enumerate(tasks):
        if n_tiers:
            t.tier = i % n_tiers
    return tasks


@pytest.mark.parametrize("policy", ["minlat", "mincost"])
def test_armed_but_idle_overload_all_paths(fd, policy):
    """``tests/test_overload.py:451`` on the torch engine."""
    def knobs(p):
        return dict(prewarm=p.o.PrewarmPolicy(min_gaps=10 ** 9),
                    reclamation=p.o.ReclamationPolicy(
                        tiers=(p.f.SLOTier(1e15, sheddable=False),
                               p.f.SLOTier(1e12)), shares=(1.0, 1.0)))

    plain = _runtime(REF, fd, FLEET3, policy).serve(
        _bursty(REF, fd, n=150, n_tiers=2))
    tasks = _bursty(PORT, fd, n=150, n_tiers=2)
    runs = [lambda rt: rt.serve(tasks), lambda rt: rt.serve_async(tasks)]
    runs += [lambda rt, cs=cs: rt.serve_stream(tasks, chunk_size=cs)
             for cs in (1, 37, 4096)]
    for run in runs:
        rt = _runtime(PORT, fd, FLEET3, policy, **knobs(PORT))
        assert_same(run(rt), plain)
        assert rt.overload.prewarm_log == [] and rt.overload.reclaim_log == []
        assert rt.engine.fallback_chunks == 0


def test_prewarm_schedule_matches_reference_across_paths(fd):
    """``tests/test_overload.py:388``: a firing pre-warm schedule is the
    reference's, on every path and chunking of the torch engine."""
    def run(p, tasks, call):
        rt = _runtime(p, fd, FLEET3, prewarm=p.o.PrewarmPolicy(count=2))
        res = call(rt, tasks)
        assert p.ref or rt.engine.fallback_chunks == 0
        return rt.overload.prewarm_log, res

    log0, base = run(REF, _bursty(REF, fd), lambda rt, ts: rt.serve(ts))
    assert len(log0) > 0
    tasks = _bursty(PORT, fd)
    for call in (lambda rt, ts: rt.serve(ts),
                 lambda rt, ts: rt.serve_async(ts),
                 lambda rt, ts: rt.serve_stream(ts, chunk_size=len(ts))):
        log, res = run(PORT, tasks, call)
        assert log == log0
        assert_same(res, base)
    log, _ = run(PORT, tasks, lambda rt, ts: rt.serve_stream(ts,
                                                             chunk_size=37))
    assert log == log0


def test_reclaim_schedule_matches_reference_across_paths(fd):
    """``tests/test_overload.py:418``: fair-share reclamation under a
    MinCost burst — victims, moves and downgrades — as the reference's."""
    def run(p, tasks, call):
        tiers = (p.f.SLOTier(3000.0, sheddable=False), p.f.SLOTier(2500.0),
                 p.f.SLOTier(2000.0))
        rt = _runtime(p, fd, FLEET3,
                      policy=lambda q: q.d.MinCostPolicy(deadline_ms=3000.0),
                      reclamation=p.o.ReclamationPolicy(
                          tiers=tiers, shares=(2.0, 1.0, 1.0)))
        res = call(rt, tasks)
        assert p.ref or rt.engine.fallback_chunks == 0
        return rt.overload.reclaim_log, res

    log0, base = run(REF, _bursty(REF, fd, n_tiers=3),
                     lambda rt, ts: rt.serve(ts))
    assert any(e[6] for e in log0)
    tasks = _bursty(PORT, fd, n_tiers=3)
    for call in (lambda rt, ts: rt.serve(ts),
                 lambda rt, ts: rt.serve_async(ts),
                 lambda rt, ts: rt.serve_stream(ts, chunk_size=len(ts))):
        log, res = run(PORT, tasks, call)
        assert log == log0
        assert_same(res, base)
        assert res.n_downgraded == base.n_downgraded


# --------------------------------------------------------------- streaming
@pytest.fixture(scope="module")
def ir():
    return {p.ref: p.fit.fit_app("IR", seed=0, n_inputs=120, configs=CONFIGS)
            for p in (REF, PORT)}


def _ir_bursty(p, setups, n, seed):
    return p.w.BurstyWorkload(rate_per_s=4.0,
                              size_sampler=setups[p.ref][0].sample_input,
                              burst_multiplier=8.0, mean_quiet_s=10.0,
                              mean_burst_s=6.0, seed=seed).generate(n)


def _ir_runtime(p, setups, c_max=6e-6, alpha=0.05, policy=None, seed=11):
    pol = policy or (lambda q: q.d.MinLatencyPolicy(c_max=c_max,
                                                    alpha=alpha))
    return _runtime(p, setups, FLEET3, pol, seed=seed)


def test_serve_stream_equals_reference_one_shot_across_chunks(ir,
                                                             monkeypatch):
    """``tests/test_streaming.py:89``: chunking changes nothing — the torch
    stream at every chunk size against the reference's one-shot serve, its
    speculation windows forced small so its repairs happen."""
    monkeypatch.setattr(_rd, "COLUMNAR_CHUNK", 64)
    ref = _ir_runtime(REF, ir).serve(_ir_bursty(REF, ir, 600, 31))
    tasks = _ir_bursty(PORT, ir, 600, 31)
    for chunk_size in (1, 7, 53, 600, 5000):
        rt = _ir_runtime(PORT, ir)
        assert_same(rt.serve_stream(tasks, chunk_size=chunk_size), ref)
        assert rt.stream_stats["n"] == 600
        r = rt.stream_stats["residency"]
        assert r["fallback_chunks"] == 0
        assert r["resident_chunks"] == rt.stream_stats["chunks"]


def test_serve_stream_hedged_fallback_matches_reference(ir):
    """``tests/test_streaming.py:157``: a hedged policy streams through the
    per-task walk, every chunk a fallback chunk."""
    def hedged(p):
        return p.d.HedgedPolicy(p.d.MinLatencyPolicy(c_max=8e-5, alpha=0.0),
                                hedge_threshold_ms=1500.0)

    ref_tasks, tasks = _same_tasks(ir, 200, 5)
    ref = _ir_runtime(REF, ir, policy=hedged, seed=17).serve(ref_tasks)
    rt = _ir_runtime(PORT, ir, policy=hedged, seed=17)
    got = rt.serve_stream(tasks, chunk_size=37)
    assert got.records.hedged.any()
    assert_same(got, ref)
    assert [r.hedge_target for r in got.records] == \
        [r.hedge_target for r in ref.records]
    assert rt.stream_stats["residency"]["fallback_chunks"] == \
        rt.stream_stats["chunks"] == 6


def test_unsorted_stream_falls_back_like_reference(ir):
    """``tests/test_streaming.py:179``: a chunk that starts before the
    stream's high-water mark flips the rest of the stream to the walk."""
    ref_tasks, tasks = _same_tasks(ir, 120, 6)
    for ts in (ref_tasks, tasks):
        for i, t in enumerate(ts):
            if i % 7 == 3:
                t.arrival_ms += 5e5
    ref = _ir_runtime(REF, ir, c_max=8e-5, alpha=0.02).serve(ref_tasks)
    rt = _ir_runtime(PORT, ir, c_max=8e-5, alpha=0.02)
    assert_same(rt.serve_stream(tasks, chunk_size=16), ref)
    assert rt.stream_stats["walked"] > 0
    # every 16-task chunk holds a spike, so every chunk is out of order
    assert rt.stream_stats["residency"]["fallback_chunks"] == \
        rt.stream_stats["chunks"] == 8


def test_stream_disorder_between_chunks_leaves_the_route(ir):
    """Chunks each in order, the third starting before the second ends:
    the first two stay on the device route (resident), the rest take the
    walk, bit-identical to the reference's stream of the same chunks."""
    ref_tasks, tasks = _same_tasks(ir, 160, 8)

    def chunks(ts):
        order = (0, 2, 1, 3)
        return (ts[k * 40:(k + 1) * 40] for k in order)

    ref = _ir_runtime(REF, ir).serve_stream(chunks(ref_tasks))
    rt = _ir_runtime(PORT, ir)
    assert_same(rt.serve_stream(chunks(tasks)), ref)
    r = rt.stream_stats["residency"]
    assert r["fallback_chunks"] == 2 and r["resident_chunks"] == 2
    assert r["fallback_syncs"] == 1


# ------------------------------------------------------------------ shards
@pytest.fixture(scope="module")
def traces(ir):
    """IR and STT Poisson traces, as the three-app shards record them."""
    stt = _rfit.fit_app("STT", seed=0, n_inputs=120, configs=CONFIGS)[0]
    out = {}
    for app, twin, n in (("IR", ir[True][0], 400), ("STT", stt, 120)):
        tasks = twin.poisson(seed=3).generate(n)
        out[app] = Trace.from_arrays(
            [t.arrival_ms for t in tasks], [t.size for t in tasks],
            [t.bytes for t in tasks], app_names=(app,))
    return out


CAND = Candidate.make("mixed3", FLEET3,
                      policy=PolicySpec("min_latency", c_max=2.97e-5,
                                        alpha=0.02),
                      cloud_configs=CONFIGS)


def _shards(traces, array_backend="torch", device="cpu"):
    return [AppShard(name=app,
                     runtime=TwinRuntimeFactory(
                         app=app, candidate=CAND, fit_configs=CONFIGS,
                         array_backend=array_backend, device=device),
                     workload=TraceChunkFactory(t), chunk_size=128)
            for app, t in traces.items()]


def _ref_shards(traces):
    from repro.planner import Candidate as RC, PolicySpec as RP
    from repro.planner import TwinRuntimeFactory as RF
    from repro.trace import Trace as RT, TraceChunkFactory as RTC

    cand = RC.make("mixed3", FLEET3, policy=RP("min_latency", c_max=2.97e-5,
                                               alpha=0.02),
                   cloud_configs=CONFIGS)
    return [RefShard(name=app, runtime=RF(app=app, candidate=cand,
                                          fit_configs=CONFIGS),
                     workload=RTC(RT.from_arrays(t.arrival_ms, t.size,
                                                 t.bytes, app_names=(app,))),
                     chunk_size=128)
            for app, t in traces.items()]


@pytest.fixture(scope="module")
def ref_sharded(traces):
    return RefSharded(_ref_shards(traces)).serve(parallel=False)


def _check_shards(res, ref_sharded, mode):
    assert res.mode == mode
    assert list(res.results) == list(ref_sharded.results)
    for app in ref_sharded.results:
        assert_same(res.results[app], ref_sharded.results[app])
        st = res.stream_stats[app]
        assert st["n"] == ref_sharded.results[app].n
        # the plain versions ran on the CPU: every tally is empty
        assert st["launches"] == {}
        assert st["residency"]["fallback_chunks"] == 0
        assert st["residency"]["resident_chunks"] == st["chunks"]


@pytest.mark.parametrize("parallel", [False, True],
                         ids=["sequential", "thread"])
def test_shards_match_reference(traces, ref_sharded, parallel):
    res = ShardedRuntime(_shards(traces)).serve(parallel=parallel)
    _check_shards(res, ref_sharded,
                  "thread" if parallel else "sequential")
    assert "TOTAL" in res.table()
    rb, codes, names = res.merged_records()
    ref_rb, ref_codes, ref_names = ref_sharded.merged_records()
    assert names == ref_names and np.array_equal(codes, ref_codes)
    assert_same(rb, ref_rb)


def test_process_shards_spawn_and_match_reference(traces, ref_sharded,
                                                  monkeypatch):
    """Process mode starts its children with ``spawn`` (a child forked
    after CUDA is initialised cannot use the card); the package's own
    factories pickle, and the children's records are the reference's."""
    contexts = []
    pool_cls = multiapp.ProcessPoolExecutor

    def watched(*args, **kwargs):
        contexts.append(kwargs.get("mp_context"))
        return pool_cls(*args, **kwargs)

    monkeypatch.setattr(multiapp, "ProcessPoolExecutor", watched)
    res = serve_sharded(_shards(traces), use_processes=True)
    assert [c.get_start_method() for c in contexts] == ["spawn"]
    assert isinstance(contexts[0], type(multiprocessing.get_context("spawn")))
    _check_shards(res, ref_sharded, "process")


@pytest.fixture
def chunk_launches(monkeypatch):
    """``serve_stream`` counts one ``gbrt_predict_multi`` launch per chunk,
    a stand-in for the card's launches; zeroes the counts around the test."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.gbrt_predict.kernel import gbrt_predict_multi

    place = _pr.PlacementRuntime.serve_stream

    def counting(self, workload, *args, **kwargs):
        res = place(self, workload, *args, **kwargs)
        for _ in range(self.stream_stats["chunks"]):
            _build.counted(gbrt_predict_multi)
        return res

    monkeypatch.setattr(_pr.PlacementRuntime, "serve_stream", counting)
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


def test_shard_launch_tallies_are_per_shard(traces, chunk_launches):
    """A shard's ``launches`` holds the launches its own thread made: with
    a wrapper standing in for a launch per chunk, each shard's tally is its
    chunk count, in threads as in sequence."""
    for parallel in (False, True):
        res = ShardedRuntime(_shards(traces)).serve(parallel=parallel)
        for app, st in res.stream_stats.items():
            assert st["launches"] == {"gbrt_predict_multi": st["chunks"]}
    total = sum(-(-t.n // 128) for t in traces.values())
    assert kernels.launch_counts()["gbrt_predict_multi"] == 2 * total


def test_sequential_shards_inside_a_recording_block(traces, ref_sharded,
                                                    chunk_launches):
    """Sequential shards run in the calling thread, so a caller already in
    a ``recording`` block nests the shards' own: each shard still tallies
    its chunks, the caller's block sees them all, and the records are the
    reference's."""
    with kernels.recording() as outer:
        res = ShardedRuntime(_shards(traces)).serve(parallel=False)
    for app, st in res.stream_stats.items():
        assert st["launches"] == {"gbrt_predict_multi": st["chunks"]}
        assert_same(res.results[app], ref_sharded.results[app])
    total = sum(-(-t.n // 128) for t in traces.values())
    assert outer == {"gbrt_predict_multi": total}


def test_shard_validation():
    rt_factory = TwinRuntimeFactory(app="IR", candidate=CAND,
                                    fit_configs=CONFIGS, device="cpu")
    live = AppShard(name="IR", runtime=rt_factory(), workload=[])
    with pytest.raises(ValueError, match="factories"):
        ShardedRuntime([live]).serve(parallel=True, use_processes=True)
    with pytest.raises(ValueError, match="duplicate"):
        ShardedRuntime([live, live])
    with pytest.raises(ValueError, match="at least one"):
        ShardedRuntime([])
    with pytest.raises(TypeError, match="PlacementRuntime"):
        AppShard(name="bad", runtime=lambda: 42, workload=[]).resolve_runtime()


# -------------------------------------------------------------- simulator
def test_simulation_wrapper_matches_reference(fd):
    ref_tasks, tasks = _same_tasks(fd, 120, 4)
    out = []
    for p, sim_mod, ts in ((REF, _rs, ref_tasks), (PORT, _ps, tasks)):
        twin, models = fd[p.ref]
        pred = p.fit.build_fleet_predictor(models, FLEET3, configs=CONFIGS)
        eng = p.d.DecisionEngine(predictor=pred,
                                 policy=POLICIES["minlat"](p), **p.engine_kw)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sim = sim_mod.Simulation(twin, eng, seed=11)
        assert any(issubclass(w.category, DeprecationWarning)
                   for w in caught)
        out.append(sim.run(ts))
        assert sim.twin is twin and sim.runtime is sim
    assert_same(out[1], out[0])
