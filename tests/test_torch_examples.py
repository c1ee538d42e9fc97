"""The port's counterparts of the documented examples (``examples/*_torch.py``)
against the JAX package's examples, on the CPU.

The reference scripts are module-level code, so each case rebuilds the
reference computation line for line from ``repro`` calls, at the
reference's sizes and seeds, and holds the port's ``run(device="cpu")`` to
it: every record BIT-IDENTICAL (targets, latencies, completions, costs,
attempts, shed flags, tiers; tolerance none), and for ``chaos_serve`` also
the breaker's opens and the pre-warm and reclamation logs.

- quickstart, placement_sim, fleet_sim, multi_app_serve (its streaming
  parity and its shards in sequence and in threads), chaos_serve, and
  async_serve's twin part against the same calls through ``repro``;
- resident_serve: the torch backend on the CPU against ``repro``'s numpy
  oracle (``jax_serve.py``'s compiled and interpret routes fail on this
  jax at ``jax_core.py:375``, so the oracle is numpy), with its residency
  counters and the continuation stream that regrows no pool;
- the live parts (serve_placement, async_serve) on the CPU at the
  reference's small model configs: every request served, none failed
  (wall-clock latencies do not compare, and the reference's XLA compiles
  would take minutes); serve_placement with its request count and tokens
  cut for the CPU;
- every ``run`` raises without CUDA unless ``device="cpu"``, and ``main``
  takes ``--device``;
- on the card (``cuda`` marker; skipped here): async_serve's live part at
  llama3.2-1b's full width, whose ``serve_async`` replays three
  executors' CUDA graphs at once on their own streams, finishes with every
  request served (graphs captured on torch's one shared capture stream
  shared a cuBLAS workspace, and these replays never finished).

``plan_capacity`` is in ``test_torch_examples_plan.py``.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.decision import (
    DecisionEngine,
    LeastPredictedWaitBalancer,
    MinCostPolicy,
    MinLatencyPolicy,
    RoundRobinBalancer,
)
from repro.core.faults import (
    AdmissionPolicy,
    CircuitBreaker,
    FaultSpec,
    OutageWindow,
    RetryPolicy,
    SLOTier,
    TransientErrors,
)
from repro.core.fit import build_fleet_predictor, build_predictor, fit_app
from repro.core.multiapp import AppShard, serve_sharded
from repro.core.overload import PrewarmPolicy, ReclamationPolicy
from repro.core.runtime import PlacementRuntime, TwinBackend
from repro.core.workload import BurstyWorkload

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "placement_sim", "fleet_sim", "resident_serve",
            "multi_app_serve", "chaos_serve", "plan_capacity",
            "serve_placement", "async_serve")

FLOAT_COLS = ("predicted_latency_ms", "predicted_cost", "actual_latency_ms",
              "actual_cost", "allowed_cost", "completion_ms", "queue_wait_ms",
              "exec_ms", "arrival_ms")
OTHER_COLS = ("predicted_cold", "actual_cold", "feasible", "attempts",
              "failed", "shed", "tier", "downgraded")


def example(name: str):
    """``examples/<name>_torch.py`` as a module."""
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same(got, ref):
    """Bit-identical records (results or record batches)."""
    ra, rb = getattr(got, "records", got), getattr(ref, "records", ref)
    assert len(ra) == len(rb)
    assert list(ra.targets) == list(rb.targets)
    for col in FLOAT_COLS + OTHER_COLS:
        x, y = getattr(ra, col), getattr(rb, col)
        if x is None or y is None:
            assert x is None and y is None, col
            continue
        assert np.array_equal(np.asarray(x), np.asarray(y)), col


# ------------------------------------------------------------- quickstart
def ref_quickstart():
    twin, models = fit_app("FD", seed=0, n_inputs=400,
                           configs=(1280, 1408, 1536, 1664, 2048))
    tasks = twin.workload(600, seed=42)
    predictor = build_predictor(models, configs=(1536, 1664, 2048))
    engine = DecisionEngine(predictor=predictor,
                            policy=MinLatencyPolicy(c_max=2.96997e-5,
                                                    alpha=0.02))
    minlat = PlacementRuntime(engine, TwinBackend(twin, seed=7)).serve(tasks)
    predictor = build_predictor(models, configs=(1280, 1408, 1664))
    engine = DecisionEngine(predictor=predictor, policy=MinCostPolicy(4500.0))
    mincost = PlacementRuntime(engine, TwinBackend(twin, seed=7)).serve(tasks)
    engine0 = DecisionEngine(predictor=build_predictor(models,
                                                       configs=(1536,)),
                             policy=MinLatencyPolicy(c_max=0.0, alpha=0.0))
    edge = PlacementRuntime(engine0, TwinBackend(twin, seed=7)).serve(tasks)
    return {"minlat": minlat, "mincost": mincost, "edge_only": edge,
            "cloud_mape": models.cloud_e2e_mape,
            "edge_mape": models.edge_e2e_mape,
            "speedup": edge.avg_actual_latency_ms
            / mincost.avg_actual_latency_ms}


def test_quickstart_matches_reference():
    got, ref = example("quickstart").run(device="cpu"), ref_quickstart()
    for k in ("minlat", "mincost", "edge_only"):
        assert_same(got[k], ref[k])
    for k in ("cloud_mape", "edge_mape", "speedup"):
        assert got[k] == ref[k], k
    assert got["mincost"].total_actual_cost == ref["mincost"].total_actual_cost


def test_quickstart_main_prints_the_reference_lines(capsys):
    assert example("quickstart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cloud end-to-end MAPE" in out
    assert "dynamic placement is" in out


# ---------------------------------------------------------- placement_sim
def test_placement_sim_matches_reference():
    mod = example("placement_sim")
    got = mod.run(device="cpu")
    twin, models = fit_app("STT", seed=0, n_inputs=300,
                           configs=(768, 1152, 1280, 1664))
    tasks = twin.workload(300, seed=5)
    assert tuple(got["by_deadline"]) == mod.DEADLINES_MS
    assert tuple(got["by_alpha"]) == mod.ALPHAS
    for d in (4500, 5000, 5500, 6000, 6500, 7000):
        pred = build_predictor(models, configs=(768, 1152, 1280, 1664))
        eng = DecisionEngine(predictor=pred, policy=MinCostPolicy(float(d)))
        ref = PlacementRuntime(eng, TwinBackend(twin, seed=9)).serve(tasks)
        assert_same(got["by_deadline"][d], ref)
    for a in (0.0, 0.01, 0.02, 0.03, 0.05, 0.1):
        pred = build_predictor(models, configs=(1152, 1280, 1664))
        eng = DecisionEngine(predictor=pred,
                             policy=MinLatencyPolicy(3.0747e-5, a))
        ref = PlacementRuntime(eng, TwinBackend(twin, seed=9)).serve(tasks)
        assert_same(got["by_alpha"][a], ref)


# -------------------------------------------------------------- fleet_sim
def test_fleet_sim_matches_reference():
    mod = example("fleet_sim")
    got = mod.run(device="cpu")
    configs, devices, c_max = mod.CONFIGS, mod.DEVICES, mod.C_MAX
    twin, models = fit_app("IR", seed=0, n_inputs=150, configs=configs)
    tasks = BurstyWorkload(rate_per_s=4.0, size_sampler=twin.sample_input,
                           burst_multiplier=6.0, mean_quiet_s=15.0,
                           mean_burst_s=6.0, seed=7).generate(3000)

    def fleet(balancer):
        pred = build_fleet_predictor(models, dict(devices), configs=configs)
        eng = DecisionEngine(predictor=pred,
                             policy=MinLatencyPolicy(c_max=c_max, alpha=0.02),
                             balancer=balancer)
        backend = TwinBackend(twin, seed=11, edge_names=tuple(devices),
                              edge_speed=devices)
        return PlacementRuntime(eng, backend).serve(tasks)

    pred = build_predictor(models, configs=configs)
    eng = DecisionEngine(predictor=pred,
                         policy=MinLatencyPolicy(c_max=c_max, alpha=0.02))
    refs = {"single edge (paper)":
            PlacementRuntime(eng, TwinBackend(twin, seed=11)).serve(tasks),
            "fleet-3 round-robin": fleet(RoundRobinBalancer()),
            "fleet-3 least-wait": fleet(LeastPredictedWaitBalancer())}
    got = got["results"]
    assert list(got) == list(refs)
    for name, ref in refs.items():
        assert_same(got[name], ref)
    assert got["fleet-3 least-wait"].device_table() == \
        refs["fleet-3 least-wait"].device_table()


# --------------------------------------------------------- resident_serve
def test_resident_serve_matches_numpy_oracle():
    mod = example("resident_serve")
    got = mod.run(device="cpu")
    twin, models = fit_app("IR", seed=0, n_inputs=120, configs=mod.CONFIGS)

    def runtime():
        pred = build_fleet_predictor(models, dict(mod.FLEET),
                                     configs=mod.CONFIGS)
        eng = DecisionEngine(predictor=pred,
                             policy=MinLatencyPolicy(c_max=mod.C_MAX,
                                                     alpha=mod.ALPHA))
        return PlacementRuntime(eng, TwinBackend(
            twin, seed=11, edge_names=tuple(mod.FLEET),
            edge_speed=mod.FLEET))

    def workload(seed, n):
        return BurstyWorkload(rate_per_s=4.0, size_sampler=twin.sample_input,
                              burst_multiplier=8.0, mean_quiet_s=10.0,
                              mean_burst_s=6.0, seed=seed).generate(n)

    chunk = mod.CHUNK
    ref = runtime().serve_stream(workload(31, mod.N_TASKS), chunk_size=chunk)
    assert_same(got["ref"], ref)
    assert_same(got["comp"], ref)
    assert got["bit_equal"] and got["dec_equal"] and got["close"]
    demo = workload(32, 6 * chunk)
    rt = runtime()
    assert_same(got["resident"],
                rt.serve_stream(demo[:3 * chunk], chunk_size=chunk))
    assert_same(got["continuation"],
                rt.serve_stream(demo[3 * chunk:], chunk_size=chunk))
    r, c = got["residency"], got["continuation_stats"]
    assert r["enabled"] and r["resident_chunks"] == 3
    assert r["chunk_commits"] == 0 and r["state_syncs"] == 1
    assert r["fallback_chunks"] == 0
    assert c["resident_chunks"] == 3 and c["pool_regrows"] == 0
    assert got["no_rebuild"]


# -------------------------------------------------------- multi_app_serve
def _ma_runtime(setups, app, c_max=0.0):
    configs, fleet = (1280, 1536, 1792), {"edge0": 1.0, "edge1": 1.0,
                                          "edge2": 0.6}
    twin, models = setups[app]
    pred = build_fleet_predictor(models, dict(fleet), configs=configs)
    eng = DecisionEngine(predictor=pred,
                         policy=MinLatencyPolicy(c_max=c_max, alpha=0.0))
    backend = TwinBackend(twin, seed=7, edge_names=tuple(fleet),
                          edge_speed=fleet)
    return PlacementRuntime(eng, backend)


def _ma_workload(setups, app):
    return setups[app][0].poisson(seed=3).chunks(100_000, chunk_size=16_384)


def test_multi_app_serve_matches_reference():
    mod = example("multi_app_serve")
    got = mod.run(device="cpu")
    setups = {app: fit_app(app, seed=0, n_inputs=120,
                           configs=(1280, 1536, 1792))
              for app in ("IR", "FD", "STT")}
    tasks = setups["STT"][0].workload(20_000, seed=3)
    one = _ma_runtime(setups, "STT").serve(tasks, batched=True)
    streamed = _ma_runtime(setups, "STT").serve_stream(tasks, chunk_size=1024)
    assert_same(got["one_shot"], one)
    assert_same(got["streamed"], streamed)
    shards = [AppShard(name=app,
                       runtime=functools.partial(_ma_runtime, setups, app),
                       workload=functools.partial(_ma_workload, setups, app),
                       chunk_size=16_384)
              for app in setups]
    seq = serve_sharded(shards, parallel=False)
    for app in setups:
        assert_same(got["sequential"].results[app], seq.results[app])
        assert_same(got["parallel"].results[app], seq.results[app])
        assert got["parallel"].stream_stats[app]["launches"] == {}
    assert got["parallel"].mode == "thread"
    assert got["sequential"].mode == seq.mode


# ------------------------------------------------------------ chaos_serve
def ref_chaos():
    configs, fleet = (1280, 1536, 1792), {"edge0": 1.0, "edge1": 1.0,
                                          "edge2": 0.6}
    twin, models = fit_app("FD", seed=0, n_inputs=120, configs=configs)
    tasks = twin.workload(2_000, seed=3)
    for t in tasks:
        t.tier = 0 if t.idx % 4 else 1
    span = tasks[-1].arrival_ms
    tiers = (SLOTier(15_000.0, sheddable=False), SLOTier(2_400.0))

    def make_runtime(faults=None, failure_aware=False, policy=None,
                     **overload):
        pred = build_fleet_predictor(models, dict(fleet), configs=configs)
        eng = DecisionEngine(predictor=pred, policy=policy or MinLatencyPolicy(
            c_max=2.97e-5, alpha=0.02))
        backend = TwinBackend(twin, seed=11, edge_names=tuple(fleet),
                              edge_speed=fleet, faults=faults)
        if not failure_aware:
            return PlacementRuntime(eng, backend, **overload)
        return PlacementRuntime(
            eng, backend,
            retry=RetryPolicy(max_attempts=4, backoff_ms=50.0,
                              backoff_mult=2.0),
            breaker=CircuitBreaker(threshold=3, probation_ms=30_000.0),
            admission=AdmissionPolicy(tiers=tiers, headroom=1.0))

    base = make_runtime().serve(tasks)
    spec = FaultSpec(seed=7, outages=[OutageWindow("edge1", 0.35 * span,
                                                   0.65 * span)],
                     transient=[TransientErrors("1792", 0.15)])
    rt = make_runtime(faults=spec, failure_aware=True)
    chaos = rt.serve(tasks)
    burst_tasks = BurstyWorkload(
        rate_per_s=2.0, size_sampler=twin.sample_input,
        burst_multiplier=20.0, mean_quiet_s=20.0, mean_burst_s=5.0,
        seed=3).generate(400)
    reactive = make_runtime().serve(burst_tasks)
    rt_pw = make_runtime(prewarm=PrewarmPolicy(count=4))
    warmed = rt_pw.serve(burst_tasks)
    for i, t in enumerate(burst_tasks):
        t.tier = i % 3
    recl = ReclamationPolicy(tiers=(SLOTier(3_000.0, sheddable=False),
                                    SLOTier(2_500.0), SLOTier(2_000.0)),
                             shares=(2.0, 1.0, 1.0))
    rt_rc = make_runtime(policy=MinCostPolicy(deadline_ms=3_000.0),
                         reclamation=recl)
    reclaimed = rt_rc.serve(burst_tasks)
    return {"baseline": base, "chaos": chaos, "chaos_runtime": rt,
            "reactive": reactive, "prewarmed": warmed,
            "prewarm_runtime": rt_pw, "reclaimed": reclaimed,
            "reclaim_runtime": rt_rc}


def test_chaos_serve_matches_reference():
    got, ref = example("chaos_serve").run(device="cpu"), ref_chaos()
    for k in ("baseline", "chaos", "reactive", "prewarmed", "reclaimed"):
        assert_same(got[k], ref[k])
    assert_same(got["again"], ref["chaos"])
    assert got["breaker_opens"] == ref["chaos_runtime"].health.n_opens > 0
    assert got["chaos"].n_shed == ref["chaos"].n_shed
    assert got["chaos"].n_retried == ref["chaos"].n_retried
    pw, pw0 = got["prewarm_runtime"].overload, \
        ref["prewarm_runtime"].overload
    assert pw.prewarm_log == pw0.prewarm_log and len(pw.prewarm_log) > 0
    assert pw.forecaster.n_triggers == pw0.forecaster.n_triggers
    assert pw.n_extensions == pw0.n_extensions
    rc, rc0 = got["reclaim_runtime"].overload, \
        ref["reclaim_runtime"].overload
    assert rc.reclaim_log == rc0.reclaim_log and len(rc.reclaim_log) > 0
    assert got["reclaimed"].n_downgraded == ref["reclaimed"].n_downgraded
    assert got["interactive_slo"] >= 0.99
    assert got["cold_prewarmed"] < got["cold_reactive"]


# ------------------------------------------------------------ async_serve
def test_async_serve_live_and_twin_parity():
    """The live part at the reference's toy config on the CPU (every
    request served by both drivers, none failed), and the twin part
    bit-identical to the same calls through ``repro``."""
    mod = example("async_serve")
    got = mod.run(device="cpu")
    live = got["live"]
    for part in ("sequential", "async"):
        res = live[part]
        assert res.n == live["n_requests"] == mod.N_REQUESTS
        assert res.n_failed == 0 and res.n_shed == 0
        assert np.all(np.isfinite(res.records.actual_latency_ms))
    assert sum(s.n_tasks for s in live["async"].device_summaries().values()) \
        == mod.N_REQUESTS

    configs, devices = mod.CONFIGS, mod.DEVICES
    twin, models = fit_app("FD", seed=0, n_inputs=150, configs=configs)
    tasks = BurstyWorkload(rate_per_s=4.0, size_sampler=twin.sample_input,
                           burst_multiplier=6.0, mean_quiet_s=15.0,
                           mean_burst_s=6.0, seed=7).generate(5000)

    def runtime():
        eng = DecisionEngine(
            predictor=build_fleet_predictor(models, dict(devices),
                                            configs=configs),
            policy=MinLatencyPolicy(c_max=1e-5, alpha=0.02))
        return PlacementRuntime(eng, TwinBackend(twin, seed=11,
                                                 edge_names=tuple(devices),
                                                 edge_speed=dict(devices)))

    batched = runtime().serve(tasks)
    rt = runtime()
    plan = rt.engine.place_many(tasks, edge_queues=rt.edge_queues)
    workers = {name: int(rows.shape[0])
               for name, rows in sorted(plan.rows_by_target().items())}
    event_driven = runtime().serve_async(tasks)
    assert_same(got["twin"]["batched"], batched)
    assert_same(got["twin"]["event_driven"], event_driven)
    assert got["twin"]["workers"] == workers


# -------------------------------------------------------- serve_placement
def test_serve_placement_live_on_the_cpu():
    """The reference's smoke-size llama3.2-1b and slices, its arrival rate,
    budget and policy; 12 requests of 64 tokens on average (the
    reference's 80 of 4,096 would decode ~160,000 eager steps here)."""
    mod = example("serve_placement")
    got = mod.run(device="cpu", n_requests=12, mean_tokens=64.0)
    res = got["result"]
    assert res.n == 12 and res.n_failed == 0 and res.n_shed == 0
    assert np.isfinite(res.avg_actual_latency_ms)
    assert sum(got["histogram"].values()) == 12
    assert set(got["histogram"]) <= {"edge", "slice2", "slice4", "slice8"}
    assert got["catalog"].model_cfg.d_model == 64


# ---------------------------------------------------------- device policy
@pytest.mark.parametrize("name", EXAMPLES)
def test_run_raises_without_cuda(name, monkeypatch):
    mod = example(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


# ------------------------------------------------------------- on the card
class _Stream:
    """A stand-in for a CUDA stream, by name."""

    def __init__(self, name):
        self.name = name

    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass

    def __eq__(self, other):
        return isinstance(other, _Stream) and other.name == self.name

    def __hash__(self):  # as torch's: one raw stream, one key
        return hash(self.name)


def test_graphs_capture_on_the_stream_that_replays_them(monkeypatch):
    """``serving.engine._capture`` warms up and captures on the caller's
    current stream (an executor's own, where it replays the graph); only a
    caller on the default stream gets a side stream. Before, every graph
    was captured on torch's one shared capture stream, so all graphs shared
    one cuBLAS workspace, and three executors replaying at once on their
    own streams (full-width ``serve_async``) never finished."""
    from repro_torch.serving import engine

    current = {"s": _Stream("executor")}
    captured_on, ran_on = [], []

    @contextlib.contextmanager
    def on_stream(s):
        prev, current["s"] = current["s"], s
        try:
            yield
        finally:
            current["s"] = prev

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"
        captured_on.append(stream.name)
        with on_stream(stream):
            yield

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: current["s"])
    monkeypatch.setattr(torch.cuda, "default_stream",
                        lambda device=None: _Stream("default"))
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: _Stream("side"))
    monkeypatch.setattr(torch.cuda, "stream", on_stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)

    def step():
        ran_on.append(current["s"].name)
        return "out"

    _, out, launches = engine._capture(step, "cuda")
    assert (out, launches) == ("out", {})
    assert ran_on == ["executor", "executor"]
    assert captured_on == ["executor"]
    current["s"] = _Stream("default")
    ran_on.clear()
    engine._capture(step, "cuda")
    assert ran_on == ["side", "side"] and captured_on[-1] == "side"


def test_executors_on_one_stream_never_replay_during_a_capture(monkeypatch):
    """``torch.cuda.Stream()`` hands out pool streams round-robin, so two
    live executors can hold one CUDA stream, and a capture records (or is
    broken by) whatever any thread puts on its stream. Two executors forced
    onto one stream: the first replays its graphs in a loop while the
    second cold-starts and captures its own. No replay on the stream runs
    while a capture is open there (``serving.engine.stream_lock``)."""
    import time

    from repro_torch.configs import smoke_config
    from repro_torch.serving import engine
    from repro_torch.serving.executors import LiveExecutor, SliceSpec

    local = threading.local()
    spans, spans_lock = [], threading.Lock()

    def current_stream(device=None):
        return getattr(local, "s", _Stream("default"))

    @contextlib.contextmanager
    def on_stream(s):
        prev, local.s = current_stream(), s
        try:
            yield
        finally:
            local.s = prev

    def span(kind, t0):
        with spans_lock:
            spans.append((kind, threading.get_ident(), t0, time.monotonic()))

    class Graph:
        def replay(self):
            t0 = time.monotonic()
            time.sleep(0.002)
            span("replay", t0)

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode=None):
        t0 = time.monotonic()
        with on_stream(stream):
            yield
            time.sleep(0.1)  # a capture takes a while
        span("capture", t0)

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "default_stream",
                        lambda device=None: _Stream("default"))
    monkeypatch.setattr(torch.cuda, "stream", on_stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)

    cfg = smoke_config("llama3.2-1b")
    warm, cold = (LiveExecutor(SliceSpec(f"s{i}", 1), cfg, seed=i,
                               device="cpu") for i in (1, 2))
    # two stream objects, one raw stream (``torch.cuda.Stream`` compares
    # and hashes by its raw stream)
    warm.stream, cold.stream = _Stream("pool0"), _Stream("pool0")
    assert engine.stream_lock(warm.stream) is engine.stream_lock(cold.stream)
    assert warm.execute(16, 64.0).cold
    spans.clear()

    started, done = threading.Event(), threading.Event()
    errors = []

    def replay_loop():
        try:
            while not done.is_set():
                assert not warm.execute(16, 64.0).cold
                started.set()
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)
            started.set()

    replayer = threading.Thread(target=replay_loop)
    replayer.start()
    started.wait(30)
    assert cold.execute(16, 64.0).cold
    time.sleep(0.05)  # let the loop replay after the capture too
    done.set()
    replayer.join(30)
    assert not errors, errors

    captures = [s for s in spans if s[0] == "capture"]
    replays = [s for s in spans if s[0] == "replay"
               and s[1] == replayer.ident]
    assert len(captures) == 2  # the cold executor's prefill and decode
    assert any(r[3] <= captures[0][2] for r in replays)
    assert any(r[2] >= captures[-1][3] for r in replays)
    for _, _, c0, c1 in captures:
        for _, _, r0, r1 in replays:
            assert r1 <= c0 or r0 >= c1, "a replay ran during a capture"


@pytest.mark.cuda
def test_full_width_serve_async_finishes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the live executors' graphs run on one")
    from repro_torch.configs import get_config

    mod = example("async_serve")
    out = {}
    worker = threading.Thread(target=lambda: out.update(mod.live_overlap(
        torch.device("cuda"), get_config("llama3.2-1b"), mod.N_REQUESTS,
        lambda *_: None)), daemon=True)
    worker.start()
    worker.join(300)
    assert not worker.is_alive(), "serve_async at full width did not finish"
    for part in ("sequential", "async"):
        assert out[part].n == mod.N_REQUESTS
        assert out[part].n_failed == 0 and out[part].n_shed == 0
