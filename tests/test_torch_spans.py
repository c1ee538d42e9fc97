"""The port's spans (``repro_torch.spans``) on the CPU: the recorder itself,
and the spans of a live ``serve_async`` and of calibration on the tiny
dense model of ``test_torch_serving.py``.

Off, a serve records nothing and reads no clock. On, each slice has one
decision pass, each dispatch one ``pool.dispatch`` on its worker thread
under the slice's ``serve.execute`` and one ``exec`` under that, carrying
the task's idx and its decode steps; a cold start's spans appear exactly
where the execution record says cold; every child lies inside its
parent; recording changes no decision; and a span lands on the
profiler's chrome trace where a ``record_function`` opened with it does.
"""

from __future__ import annotations

import json
import math
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core.decision import MinLatencyPolicy
from repro_torch.serving.executors import SliceSpec
from repro_torch.serving.placement import (
    calibrate_catalog,
    llm_workload,
    make_live_runtime,
)
from test_torch_serving import CPU, tiny_catalog, tiny_cfg  # noqa: F401


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _runtime(cat):
    return make_live_runtime(cat, MinLatencyPolicy(c_max=0.01, alpha=0.05),
                             t_idl_ms=30_000.0, n_edge_devices=2, device=CPU)


def _slices(n=2, per=10):
    tasks = llm_workload(n * per, rate_per_s=40.0, seed=3, mean_tokens=128)
    return [tasks[i * per:(i + 1) * per] for i in range(n)]


def _decisions(res):
    r = res.records
    return (list(r.target_names), np.asarray(r.target_codes).tolist(),
            np.asarray(r.predicted_latency_ms).tolist(),
            np.asarray(r.predicted_cost).tolist(),
            np.asarray(r.predicted_cold).tolist())


# ------------------------------------------------------------- the recorder
def test_nesting_explicit_parent_and_drain():
    anchor = spans.enable()
    with spans.span("a", k=1) as a:
        with spans.span("b") as b:
            b.set(x=2)
            pid = spans.current()
        box = {}

        def worker():
            with spans.span("w", parent=pid) as w:
                box["tid"] = threading.get_native_id()
                box["id"] = w.id

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    got, anchor2 = spans.drain()
    assert anchor2 == anchor
    by = {s.name: s for s in got}
    assert [s.name for s in got] == ["a", "b", "w"]
    assert by["a"].parent == 0 and by["b"].parent == a.id
    assert by["w"].parent == pid == b.id and by["w"].id == box["id"]
    assert by["w"].tid == box["tid"] != by["a"].tid
    assert by["a"].attrs == {"k": 1} and by["b"].attrs == {"x": 2}
    assert spans.drain()[0] == []  # drained once
    spans.enable()
    assert spans.drain()[0] == []  # enable drops what was kept


def test_off_returns_the_shared_null_span():
    assert not spans.enabled()
    s1, s2 = spans.span("a", k=1), spans.span("b")
    assert s1 is s2 and s1.id == 0 and spans.current() == 0
    with s1 as s:
        s.set(x=1)
    assert spans.drain()[0] == []


def test_threads_lose_no_span():
    """More threads than cores, switching as often as the interpreter
    allows: every span of every thread is drained once, ids unique."""
    n_threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        spans.enable()

        def worker():
            for _ in range(per):
                with spans.span("outer"):
                    with spans.span("inner"):
                        pass

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got, _ = spans.drain()
    assert len(got) == 2 * n_threads * per
    assert len({s.id for s in got}) == len(got)
    by_id = {s.id: s for s in got}
    assert all(by_id[s.parent].name == "outer" and by_id[s.parent].tid == s.tid
               for s in got if s.name == "inner")


# ------------------------------------------------------ the serving path
def test_off_serve_records_nothing_and_reads_no_clock(
        tiny_catalog, monkeypatch):  # noqa: F811
    rt = _runtime(tiny_catalog)

    def no_clock():
        raise AssertionError("a span read the clock while recording is off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    for tasks in _slices():
        res = rt.serve_async(tasks)
        assert res.n == len(tasks)
    monkeypatch.undo()
    assert spans.drain()[0] == []


def test_serve_async_spans(tiny_catalog):  # noqa: F811
    rt = _runtime(tiny_catalog)
    pool = rt.backend.pool
    slices = _slices()
    spans.enable()
    results = [rt.serve_async(tasks) for tasks in slices]
    got, _ = spans.drain()
    by_id = {s.id: s for s in got}

    def kids(s, name=None):
        return [c for c in got if c.parent == s.id
                and (name is None or c.name == name)]

    for s in got:  # every child lies inside its parent
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (p, s)

    main_tid = threading.get_native_id()
    top = [s for s in got if s.name == "serve.slice"]
    assert len(top) == len(slices)
    for sl, tasks, res in zip(top, slices, results):
        assert sl.parent == 0 and sl.tid == main_tid
        assert sl.attrs == {"tasks": len(tasks)}
        assert [c.name for c in kids(sl)] == ["serve.place", "serve.execute",
                                              "serve.records"]
        (ex,) = kids(sl, "serve.execute")
        dispatch = kids(ex, "pool.dispatch")
        # one dispatch per task (MinLatency sends no hedges), on a worker
        assert sorted(d.attrs["task"] for d in dispatch) \
            == [t.idx for t in tasks]
        names = list(res.records.target_names)
        codes = np.asarray(res.records.target_codes)
        cold = np.asarray(res.records.actual_cold)
        for d in dispatch:
            i = d.attrs["task"] - tasks[0].idx
            task = tasks[i]
            assert d.tid != main_tid
            assert d.attrs["target"] == names[codes[i]]
            (e,) = kids(d, "exec")
            spec = pool.specs.get(d.attrs["target"]) \
                or pool.edges[d.attrs["target"]].spec
            assert e.attrs["steps"] == max(math.ceil(
                int(task.size) / (spec.chips * spec.tokens_per_step)), 1)
            assert e.attrs["cold"] == bool(cold[i])
            colds = kids(e, "cold")
            assert len(colds) == int(bool(cold[i]))
            for c in colds:
                assert [k.name for k in kids(c)] == ["cold.weights",
                                                     "cold.warmup"]
            assert [k.name for k in kids(e)] == \
                ["exec.lock"] + ["cold"] * len(colds) \
                + ["exec.feed", "exec.launch", "exec.sync", "exec.store"]
            cloud = d.attrs["target"] in pool.specs
            assert [k.name for k in kids(d)] == \
                (["pool.lease", "exec", "pool.land"] if cloud else ["exec"])
            if cloud:
                (lease,) = kids(d, "pool.lease")
                assert set(lease.attrs) == {"cap_wait_ms", "reclaimed"}
    assert any(s.attrs.get("cold") for s in got if s.name == "exec")


def test_calibration_and_pool_cold_starts(tiny_cfg):  # noqa: F811
    """Calibration's cold starts (its warm-up, one per config and cold
    sample, its warm executors and edge) and the pool's edge executor's
    each have one ``cold`` span, under their own parent spans."""
    specs = [SliceSpec("s2", 2, tokens_per_step=4),
             SliceSpec("s8", 8, tokens_per_step=4)]
    spans.enable()
    cat = calibrate_catalog(tiny_cfg, specs, n_tasks=2, n_cold=1, seed=0,
                            device=CPU)
    _runtime(cat)
    got, _ = spans.drain()
    by_id = {s.id: s for s in got}
    (cal,) = [s for s in got if s.name == "calibrate"]
    parts = [s for s in got if s.parent == cal.id]
    assert [s.name for s in parts] == ["calibrate.cold", "calibrate.warm",
                                       "calibrate.fit"]
    colds = [s for s in got if s.name == "cold"]

    def under(s):
        while s.parent:
            s = by_id[s.parent]
            if s.name in ("calibrate.cold", "calibrate.warm", "pool.make"):
                return s.name
        return None

    where = [under(c) for c in colds]
    assert where.count("calibrate.cold") == 1 + len(specs)
    assert where.count("calibrate.warm") == len(specs) + 1
    assert where.count("pool.make") == 2  # two edge devices
    assert len(where) == 2 * len(specs) + 4


def test_recording_changes_no_decision(tiny_catalog):  # noqa: F811
    rt = _runtime(tiny_catalog)
    off = [_decisions(rt.serve_async(t)) for t in _slices()]
    rt = _runtime(tiny_catalog)
    spans.enable()
    on = [_decisions(rt.serve_async(t)) for t in _slices()]
    assert on == off


def test_span_lands_on_the_chrome_trace(tmp_path):
    """A main-thread span, mapped through the anchor, starts within 200 us
    of a ``record_function`` range opened with it, on the same thread."""
    from torch.profiler import ProfilerActivity, profile, record_function

    anchor = spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            torch.ones(8).sum()
        with spans.span("probe"), record_function("probe"):
            torch.ones(64).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    (ev,) = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["name"] == "probe"]
    (sp,) = [s for s in spans.drain()[0] if s.name == "probe"]
    base = int(trace["baseTimeNanoseconds"])
    start_us = (anchor.wall_ns(sp.start_ns) - base) / 1e3
    end_us = (anchor.wall_ns(sp.end_ns) - base) / 1e3
    assert abs(float(ev["ts"]) - start_us) < 200.0
    assert abs(float(ev["ts"]) + float(ev["dur"]) - end_us) < 200.0
    assert ev["tid"] == sp.tid
