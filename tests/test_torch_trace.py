"""The port's traces (``repro_torch.trace``) against the JAX package's.

The cases of ``tests/test_trace.py``, run against the port, with every
replay on the torch placement core (``array_backend="torch",
device="cpu"``) held BIT-IDENTICAL per record to the reference's numpy serve
of the same tasks:

- JSONL and NPZ round trips are bit-exact; unknown extensions, malformed
  headers and rows, unsorted / NaN / negative / out-of-range records are
  rejected with the offending record named;
- a trace file written by either package loads in the other and is
  ``equal`` (both formats, both directions, with and without the latency
  column and a fault spec in its meta);
- an EMPTY trace with an observed-latency column round-trips through the
  port's JSONL (its header marks the column); the reference's JSONL loses
  the column, and its own red test of that stays as it is;
- ``TraceWorkload`` replay ≡ in-memory serve at every chunk size, after a
  disk round trip too; capture → replay round-trips exactly, for kept-task
  runs and constant-memory streams (``keep_inputs=True``);
- multi-app: ``split_by_app``/``merge`` invert each other, ``trace_shards``
  replay ≡ filtering per app up front, ``capture_sharded`` agrees with
  ``merged_records``, and spawn-process shards match sequential ones.
Tolerance: none.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import repro.trace as ref_trace
from repro.core.decision import DecisionEngine as RefEngine
from repro.core.decision import MinLatencyPolicy as RefMinLat
from repro.core.faults import FaultSpec as RefFaultSpec
from repro.core.faults import TransientErrors as RefTransient
from repro.core.fit import build_fleet_predictor as ref_build_fleet
from repro.core.fit import fit_app as ref_fit_app
from repro.core.runtime import PlacementRuntime as RefRuntime
from repro.core.runtime import TwinBackend as RefTwinBackend
from repro.core.workload import BurstyWorkload as RefBursty
from repro_torch.core.decision import DecisionEngine, MinLatencyPolicy
from repro_torch.core.faults import FaultSpec, TransientErrors
from repro_torch.core.fit import build_fleet_predictor, fit_app
from repro_torch.core.multiapp import serve_sharded
from repro_torch.core.runtime import PlacementRuntime, TwinBackend
from repro_torch.core.workload import (
    BurstyWorkload,
    PoissonWorkload,
    first_disorder,
)
from repro_torch.planner import Candidate, PolicySpec, TwinRuntimeFactory
from repro_torch.trace import (
    Trace,
    TraceError,
    TraceWorkload,
    capture,
    capture_sharded,
    fault_spec_of,
    load,
    merge,
    trace_shards,
)

CONFIGS = (1280, 1536, 1792)
FLEET = {"edge0": 1.0, "edge1": 1.0, "edge2": 0.6}
NAMES = tuple(FLEET)

RECORD_COLS = ("predicted_latency_ms", "predicted_cost", "actual_latency_ms",
               "actual_cost", "allowed_cost", "completion_ms", "queue_wait_ms",
               "exec_ms", "hedge_exec_ms", "predicted_cold", "actual_cold",
               "feasible", "hedged", "arrival_ms")


@pytest.fixture(scope="module")
def ir_setup():
    return fit_app("IR", seed=0, n_inputs=120, configs=CONFIGS)


@pytest.fixture(scope="module")
def stt_setup():
    return fit_app("STT", seed=0, n_inputs=120, configs=CONFIGS)


@pytest.fixture(scope="module")
def ref_ir():
    return ref_fit_app("IR", seed=0, n_inputs=120, configs=CONFIGS)


def _runtime(twin, models, c_max=6e-6, alpha=0.05, seed=11):
    """The port's runtime, on the torch placement core on the CPU."""
    pred = build_fleet_predictor(models, dict(FLEET), configs=CONFIGS)
    eng = DecisionEngine(predictor=pred,
                         policy=MinLatencyPolicy(c_max=c_max, alpha=alpha),
                         array_backend="torch", device="cpu")
    backend = TwinBackend(twin, seed=seed, edge_names=NAMES, edge_speed=FLEET)
    return PlacementRuntime(eng, backend)


def _ref_serve(ref_ir, n, seed):
    """The reference's numpy serve of the bursty IR stream (the oracle)."""
    twin, models = ref_ir
    tasks = RefBursty(rate_per_s=4.0, size_sampler=twin.sample_input,
                      burst_multiplier=8.0, mean_quiet_s=10.0,
                      mean_burst_s=6.0, seed=seed).generate(n)
    pred = ref_build_fleet(models, dict(FLEET), configs=CONFIGS)
    eng = RefEngine(predictor=pred, policy=RefMinLat(c_max=6e-6, alpha=0.05))
    rt = RefRuntime(eng, RefTwinBackend(twin, seed=11, edge_names=NAMES,
                                        edge_speed=FLEET))
    return rt.serve(tasks, batched=True)


def _bursty_trace(twin, n, seed=31, app="IR"):
    tasks = BurstyWorkload(rate_per_s=4.0, size_sampler=twin.sample_input,
                           burst_multiplier=8.0, mean_quiet_s=10.0,
                           mean_burst_s=6.0, seed=seed).generate(n)
    return tasks, Trace.from_tasks(tasks, app=app)


def assert_records_equal(a, b):
    assert len(a) == len(b)
    assert list(a.targets) == list(b.targets)
    for col in RECORD_COLS:
        assert np.array_equal(getattr(a, col), getattr(b, col)), col


def _toy_trace(n=50, seed=3, apps=("IR",), lat=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, len(apps), size=n)
    return Trace.from_arrays(
        arrival_ms=np.cumsum(rng.exponential(250.0, size=n)),
        size=rng.uniform(1e4, 1e6, size=n),
        bytes=rng.uniform(1e3, 1e5, size=n),
        app_codes=codes, app_names=apps,
        observed_latency_ms=rng.uniform(10.0, 5e4, size=n) if lat else None,
        meta={"source": "toy"})


# ------------------------------------------------------------ format round trips
@pytest.mark.parametrize("ext", ["jsonl", "npz"])
def test_round_trips_bit_exact(tmp_path, ext):
    t = _toy_trace(apps=("IR", "STT"))
    p = tmp_path / f"t.{ext}"
    t.save(p)
    back = load(p)
    assert back.equal(t)
    assert back.app_names == t.app_names and back.meta == {"source": "toy"}
    assert np.array_equal(back.arrival_ms, t.arrival_ms)
    assert np.array_equal(back.observed_latency_ms, t.observed_latency_ms)


@pytest.mark.parametrize("ext", ["jsonl", "npz"])
def test_round_trip_without_observed_latency(tmp_path, ext):
    t = _toy_trace(lat=False)
    assert t.observed_latency_ms is None
    t.save(tmp_path / f"a.{ext}")
    back = load(tmp_path / f"a.{ext}")
    assert back.equal(t) and back.observed_latency_ms is None


@pytest.mark.parametrize("ext", ["jsonl", "npz"])
@pytest.mark.parametrize("lat", [False, True], ids=["no_lat", "lat"])
def test_empty_trace_round_trip(tmp_path, ext, lat):
    """The fault the port does not copy: an empty trace that HAS the
    latency column loads back with it (the JSONL header marks it)."""
    t = Trace.from_arrays([], [], [], app_names=("IR",),
                          observed_latency_ms=[] if lat else None)
    assert t.n == 0 and t.duration_ms == 0.0
    t.save(tmp_path / f"e.{ext}")
    back = load(tmp_path / f"e.{ext}")
    assert back.equal(t)
    assert (back.observed_latency_ms is not None) == lat
    if ext == "jsonl":
        header = json.loads((tmp_path / "e.jsonl").read_text().splitlines()[0])
        assert header["lat"] is lat


def test_reference_jsonl_loses_empty_latency_column(tmp_path):
    """What the mark repairs: the reference writes no mark, so its empty
    trace with a latency column loads back (in either package) without
    it; the port's file of the same trace keeps it in both."""
    ref_t = ref_trace.Trace.from_arrays([], [], [], app_names=("IR",),
                                        observed_latency_ms=[])
    ref_t.save(tmp_path / "ref.jsonl")
    assert load(tmp_path / "ref.jsonl").observed_latency_ms is None
    Trace.from_arrays([], [], [], app_names=("IR",),
                      observed_latency_ms=[]).save(tmp_path / "port.jsonl")
    assert load(tmp_path / "port.jsonl").observed_latency_ms is not None
    # the reference ignores the mark and infers from the (no) rows
    assert ref_trace.load(tmp_path / "port.jsonl").observed_latency_ms is None


@pytest.mark.parametrize("ext", ["jsonl", "npz"])
@pytest.mark.parametrize("lat", [False, True], ids=["no_lat", "lat"])
def test_files_cross_the_packages_both_ways(tmp_path, ext, lat):
    t = _toy_trace(apps=("IR", "STT"), lat=lat)
    spec = FaultSpec(seed=6, transient=[TransientErrors("1536", 0.2)])
    t.meta["fault_spec"] = spec.to_json()
    ref_t = ref_trace.Trace.from_arrays(
        t.arrival_ms, t.size, t.bytes, t.app_codes, t.app_names,
        observed_latency_ms=t.observed_latency_ms, meta=dict(t.meta))
    t.save(tmp_path / f"port.{ext}")
    ref_t.save(tmp_path / f"ref.{ext}")
    from_port = ref_trace.load(tmp_path / f"port.{ext}")
    from_ref = load(tmp_path / f"ref.{ext}")
    assert from_port.equal(ref_t) and from_ref.equal(t)
    assert from_ref.meta == t.meta and from_port.meta == ref_t.meta
    assert fault_spec_of(from_ref) == spec
    assert ref_trace.fault_spec_of(from_port) == RefFaultSpec(
        seed=6, transient=[RefTransient("1536", 0.2)])


def test_load_save_reject_unknown_extension(tmp_path):
    t = _toy_trace()
    with pytest.raises(TraceError, match="cannot infer trace format"):
        t.save(tmp_path / "t.csv")
    with pytest.raises(TraceError, match="cannot infer trace format"):
        load(tmp_path / "t.csv")


def test_jsonl_rejects_wrong_header_and_bad_rows(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"not": "a trace"}\n')
    with pytest.raises(TraceError, match="header"):
        load(p)
    p.write_text('{"schema": "repro.trace", "version": 1, "apps": ["IR"]}\n'
                 '{"t": 1.0, "size": 5.0, "bytes": 2.0}\n')
    with pytest.raises(TraceError, match="line 2.*'app'"):
        load(p)
    p.write_text('{"schema": "repro.trace", "version": 1, "apps": ["IR"]}\n'
                 '{"t": 1.0, "app": 0, "size": 5.0, "bytes": 2.0, "lat": 9.0}\n'
                 '{"t": 2.0, "app": 0, "size": 5.0, "bytes": 2.0}\n')
    with pytest.raises(TraceError, match="line 3.*all-or-none"):
        load(p)


@pytest.mark.parametrize("mark,row,match", [
    ("true", '{"t": 1.0, "app": 0, "size": 5.0, "bytes": 2.0}',
     "line 2 is missing 'lat'"),
    ("false", '{"t": 1.0, "app": 0, "size": 5.0, "bytes": 2.0, "lat": 3.0}',
     "line 2 has 'lat'"),
    ('"yes"', '{"t": 1.0, "app": 0, "size": 5.0, "bytes": 2.0}',
     "must be true or false"),
])
def test_jsonl_rows_must_agree_with_the_latency_mark(tmp_path, mark, row,
                                                     match):
    p = tmp_path / "m.jsonl"
    p.write_text('{"schema": "repro.trace", "version": 1, "apps": ["IR"], '
                 f'"lat": {mark}}}\n{row}\n')
    with pytest.raises(TraceError, match=match):
        load(p)


def test_version_gate(tmp_path):
    p = tmp_path / "new.jsonl"
    p.write_text('{"schema": "repro.trace", "version": 99, "apps": ["IR"]}\n')
    with pytest.raises(TraceError, match="version 99"):
        load(p)


# ------------------------------------------------------------------ validation
def test_unsorted_trace_rejected_with_offending_index():
    arr = [0.0, 10.0, 5.0, 20.0]
    with pytest.raises(TraceError) as e:
        Trace.from_arrays(arr, [1, 1, 1, 1], [1, 1, 1, 1])
    msg = str(e.value)
    assert "record 2" in msg and "10.0" in msg and "5.0" in msg
    assert first_disorder(arr) == 2
    assert "per-task walk" in msg


def test_nan_and_negative_inputs_rejected_with_index():
    with pytest.raises(TraceError, match="record 1: NaN size"):
        Trace.from_arrays([0.0, 1.0], [1.0, float("nan")], [1.0, 1.0])
    with pytest.raises(TraceError, match="record 0: negative bytes"):
        Trace.from_arrays([0.0, 1.0], [1.0, 1.0], [-3.0, 1.0])
    with pytest.raises(TraceError, match="non-finite arrival"):
        Trace.from_arrays([0.0, float("inf")], [1.0, 1.0], [1.0, 1.0])


def test_app_code_and_name_validation():
    with pytest.raises(TraceError, match="record 1: app code 7"):
        Trace.from_arrays([0.0, 1.0], [1, 1], [1, 1], app_codes=[0, 7],
                          app_names=("IR",))
    with pytest.raises(TraceError, match="duplicate app names"):
        Trace.from_arrays([0.0], [1], [1], app_names=("IR", "IR"))
    with pytest.raises(TraceError, match="unknown app 'FD'.*IR"):
        _toy_trace().for_app("FD")
    with pytest.raises(TraceError, match="'size' has 1 records but"):
        Trace.from_arrays([0.0, 1.0], [1.0], [1.0, 1.0])


# --------------------------------------------------------------- replay parity
def test_trace_replay_matches_reference_at_every_chunk_size(ir_setup, ref_ir):
    """The tentpole guarantee on the torch core: a ``TraceWorkload``
    streamed through ``serve_stream`` is per-record identical to the
    reference's in-memory serve of the tasks it was recorded from."""
    twin, models = ir_setup
    _, trace = _bursty_trace(twin, 500)
    ref = _ref_serve(ref_ir, 500, 31)
    tw = TraceWorkload(trace)
    for chunk_size in (1, 53, 256, 5000):
        rt = _runtime(twin, models)
        res = rt.serve_stream(tw.chunks(chunk_size=chunk_size))
        assert_records_equal(res.records, ref.records)
        assert rt.stream_stats["residency"]["fallback_chunks"] == 0
    res = _runtime(twin, models).serve_stream(tw.task_chunk(), chunk_size=97)
    assert_records_equal(res.records, ref.records)


@pytest.mark.parametrize("ext", ["jsonl", "npz"])
def test_trace_replay_after_disk_round_trip(ir_setup, ref_ir, tmp_path, ext):
    twin, models = ir_setup
    _, trace = _bursty_trace(twin, 300, seed=5)
    ref = _ref_serve(ref_ir, 300, 5)
    trace.save(tmp_path / f"t.{ext}")
    res = _runtime(twin, models).serve_stream(
        TraceWorkload(load(tmp_path / f"t.{ext}")).chunks(chunk_size=64))
    assert_records_equal(res.records, ref.records)


def test_trace_workload_generate_matches_chunks(ir_setup):
    _, trace = _bursty_trace(ir_setup[0], 200, seed=8)
    tw = TraceWorkload(trace)
    gen = tw.generate()
    assert len(gen) == 200 and len(tw) == tw.n == 200
    flat = [t for c in tw.chunks(chunk_size=17) for t in c]
    for a, b in zip(gen, flat):
        assert (a.arrival_ms, a.size, a.bytes) == (b.arrival_ms, b.size,
                                                   b.bytes)
    with pytest.raises(TraceError, match="only 200 records"):
        tw.generate(201)


# ------------------------------------------------------------------- capture
def test_capture_replay_round_trip(ir_setup, ref_ir):
    twin, models = ir_setup
    tasks, _ = _bursty_trace(twin, 400, seed=13)
    ref = _ref_serve(ref_ir, 400, 13)
    rt = _runtime(twin, models)
    rt.engine.array_backend = "torch"
    first = rt.serve(tasks)
    assert rt.engine.fallback_chunks == 0
    assert_records_equal(first.records, ref.records)
    t = capture(first, app="IR")
    assert np.array_equal(t.observed_latency_ms,
                          ref.records.actual_latency_ms)
    assert t.equal(_as_port(ref_trace.capture(ref, app="IR")))
    res = _runtime(twin, models).serve_stream(
        TraceWorkload(t).chunks(chunk_size=71), keep_inputs=True)
    assert_records_equal(res.records, ref.records)
    assert capture(res, app="IR").equal(t)


def _as_port(t) -> Trace:
    return Trace.from_arrays(t.arrival_ms, t.size, t.bytes, t.app_codes,
                             t.app_names,
                             observed_latency_ms=t.observed_latency_ms,
                             meta=t.meta)


def test_capture_from_constant_memory_stream(ir_setup, ref_ir):
    twin, models = ir_setup
    _, trace = _bursty_trace(twin, 300, seed=21)
    ref = _ref_serve(ref_ir, 300, 21)
    res = _runtime(twin, models).serve_stream(
        TraceWorkload(trace).chunks(chunk_size=64), keep_tasks=False,
        keep_inputs=True)
    assert res.records.tasks == []
    assert capture(res, app="IR").equal(
        _as_port(ref_trace.capture(ref, app="IR")))
    res2 = _runtime(twin, models).serve_stream(
        TraceWorkload(trace).chunks(chunk_size=64), keep_tasks=False)
    with pytest.raises(ValueError, match="keep_inputs=True"):
        capture(res2, app="IR")


# ------------------------------------------------------------------ multi-app
def _multiapp_trace(ir_setup, stt_setup, n_ir=200, n_stt=60):
    ir = Trace.from_tasks(
        PoissonWorkload(rate_per_s=4.0, size_sampler=ir_setup[0].sample_input,
                        seed=3).generate(n_ir), app="IR")
    stt = Trace.from_tasks(
        PoissonWorkload(rate_per_s=0.5,
                        size_sampler=stt_setup[0].sample_input,
                        seed=4).generate(n_stt), app="STT")
    return merge({"IR": ir, "STT": stt})


def test_merge_split_invert_and_match_reference(ir_setup, stt_setup):
    m = _multiapp_trace(ir_setup, stt_setup)
    assert m.app_names == ("IR", "STT")
    assert first_disorder(m.arrival_ms) == -1
    parts = m.split_by_app()
    assert merge(parts).equal(m)
    assert parts["IR"].n + parts["STT"].n == m.n
    with pytest.raises(TraceError, match="single-app"):
        merge({"both": m})
    ref_parts = {a: ref_trace.Trace.from_arrays(
        t.arrival_ms, t.size, t.bytes, app_names=(a,))
        for a, t in parts.items()}
    assert _as_port(ref_trace.merge(ref_parts)).equal(m)


def test_sharded_replay_equals_upfront_filter(ir_setup, stt_setup):
    m = _multiapp_trace(ir_setup, stt_setup)
    setups = {"IR": ir_setup, "STT": stt_setup}
    shards = trace_shards(m, {a: _runtime(*s) for a, s in setups.items()},
                          chunk_size=64)
    sharded = serve_sharded(shards, parallel=False)
    for app, (twin, models) in setups.items():
        solo = _runtime(twin, models).serve_stream(
            TraceWorkload(m.for_app(app)).chunks(chunk_size=64))
        assert_records_equal(sharded.results[app].records, solo.records)
        assert sharded.stream_stats[app]["launches"] == {}
    with pytest.raises(TraceError, match=r"\['STT'\]"):
        trace_shards(m, {"IR": _runtime(*ir_setup)})


def test_capture_sharded_round_trip(ir_setup, stt_setup):
    m = _multiapp_trace(ir_setup, stt_setup, n_ir=150, n_stt=40)
    shards = trace_shards(
        m, {"IR": _runtime(*ir_setup), "STT": _runtime(*stt_setup)},
        chunk_size=64, keep_tasks=True)
    sharded = serve_sharded(shards, parallel=True)
    t = capture_sharded(sharded)
    for col in ("arrival_ms", "size", "bytes", "app_codes"):
        assert np.array_equal(getattr(t, col), getattr(m, col)), col
    rb, codes, names = sharded.merged_records()
    assert names == ("IR", "STT")
    assert np.array_equal(rb.arrival_ms, t.arrival_ms)
    assert np.array_equal(codes, t.app_codes)
    assert np.array_equal(rb.actual_latency_ms, t.observed_latency_ms)


def test_trace_shards_process_mode(ir_setup):
    """``as_factories=True`` with the planner's runtime factory: spawned
    children replay bit-identically to the sequential replay."""
    _, trace = _bursty_trace(ir_setup[0], 200, seed=17)
    single = merge({"IR": trace})
    factory = TwinRuntimeFactory(
        app="IR", candidate=Candidate.make(
            "c", FLEET, policy=PolicySpec("min_latency", c_max=6e-6,
                                          alpha=0.05),
            cloud_configs=CONFIGS), fit_configs=CONFIGS, device="cpu")
    seq = serve_sharded(trace_shards(single, {"IR": factory}, chunk_size=64),
                        parallel=False)
    proc = serve_sharded(trace_shards(single, {"IR": factory}, chunk_size=64,
                                      as_factories=True),
                         parallel=True, use_processes=True)
    assert proc.mode == "process"
    assert_records_equal(seq.results["IR"].records,
                         proc.results["IR"].records)
    assert proc.stream_stats["IR"]["launches"] == {}


# ---------------------------------------------------------------- misc shapes
def test_prefix_and_duration():
    t = _toy_trace(n=20)
    p = t.prefix(7)
    assert p.n == 7 and np.array_equal(p.arrival_ms, t.arrival_ms[:7])
    assert t.prefix(10_000).n == 20
    assert t.prefix(0).n == 0
    assert t.duration_ms == float(t.arrival_ms[-1] - t.arrival_ms[0])
