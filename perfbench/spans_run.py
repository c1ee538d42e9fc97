#!/usr/bin/env python3
"""One run of a cell of ``BENCHMARK.json``, made as ``run.py`` makes it,
with the program's spans (``repro_torch.spans``) recorded from the start:

    python3 perfbench/spans_run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--spans <0|1>]

With ``--trace 1`` (spans on) the result line's ``metrics`` hold, beside
the cell's per-layer metrics, the span metrics of ``SPAN_METRICS`` (their
readers are ``metrics/<name>.py``), and a ``spans`` object holds the idle
split in seconds, how far the program's spans lie from the profiler's own
ranges on the trace (``alignment``), each cold execution of the window
beside its record's ``start_ms`` (``cold_vs_record``), and set-up by span
(``setup``). With ``--trace 0 --spans 1`` the line holds the end-to-end
metrics with the recorder on and the profiler off, and ``setup``;
``--trace 0 --spans 0`` is ``run.py``'s run.

The harness is wrapped from outside, as ``pb_capture`` wraps the program:
``pb_harness._read_trace`` also returns the trace's gaps, its base time
and the drained spans (``pb_spans``), ``pb_common.metrics_of`` adds
``SPAN_METRICS`` to a cell's per-layer metrics, and the run's ``Capture``
is kept to compare the window's executions with their spans. Exit codes
are ``run.py``'s.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

CELLS = ["olmoe-long", "mamba2-long"]
SPAN_METRICS = [
    {"name": "launch_idle_pct", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "steps", "moves": "tasks_per_s",
     "workloads": CELLS},
    {"name": "pool_idle_pct", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "executor pool",
     "moves": "tasks_per_s", "workloads": CELLS},
    {"name": "serve_idle_pct", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "serve loop", "moves": "tasks_per_s",
     "workloads": CELLS},
    {"name": "cold_weights_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "executor pool", "moves": "setup_s",
     "workloads": CELLS},
    {"name": "cold_capture_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "executor pool", "moves": "setup_s",
     "workloads": CELLS},
    {"name": "calibrate_s", "unit": "s", "better": "lower",
     "source": "program_span", "layer": "predictor", "moves": "setup_s",
     "workloads": CELLS},
]
COLD_PARTS = ("cold", "cold.weights", "cold.warmup", "cold.capture",
              "cold.capture_lock")


def run(cell: str, seed: int, seconds: float, trace: bool, spans_on: bool,
        t_start: float | None = None, **run_cell_kw) -> dict:
    """One run of ``cell`` through ``pb_harness.run_cell`` (``run_cell_kw``
    passed on), with the recorder on when ``spans_on`` or ``trace``."""
    import pb_common as pc
    import pb_harness
    import pb_spans
    from repro_torch import spans

    kept: dict = {}
    read_trace, metrics_of = pb_harness._read_trace, pc.metrics_of
    capture = pb_harness.Capture

    class KeptCapture(capture):
        """The harness's ``Capture``, kept, with the executions it drops
        at the window's start."""

        def install(self):
            kept["cap"] = self
            kept["warmup_execs"] = []
            super().install()

        def reset(self):
            kept["warmup_execs"] += self.execs
            super().reset()

    def span_metrics_of(bench, kind, name):
        out = metrics_of(bench, kind, name)
        if kind == "per_layer":
            out = out + [m for m in SPAN_METRICS if name in m["workloads"]]
        return out

    t_start = time.perf_counter() if t_start is None else t_start
    pb_harness._read_trace = functools.partial(span_read_trace, read_trace,
                                               kept=kept)
    pc.metrics_of = span_metrics_of
    pb_harness.Capture = KeptCapture
    if spans_on or trace:
        spans.enable()
    try:
        out = pb_harness.run_cell(cell, seed, seconds, trace,
                                  t_start=t_start, **run_cell_kw)
    finally:
        spans.disable()
        pb_harness._read_trace, pc.metrics_of = read_trace, metrics_of
        pb_harness.Capture = capture
    if "spans" not in kept:
        kept["spans"], kept["anchor"] = spans.drain()
    if not (spans_on or trace):
        return out
    window = {**pc.load_workload(cell)["window"],
              **run_cell_kw.get("workload_overrides", {}).get("window", {})}
    rep = {"setup": setup_split(kept["spans"], t_start,
                                window["warmup_slices"]),
           "cold_vs_record": cold_vs_record(
               kept["spans"], kept["warmup_execs"] + kept["cap"].execs)}
    if trace:
        split = dict(pb_spans.idle_split(kept["ctx"]) or {})
        rep.update(idle_s=split, alignment=kept["alignment"])
    out["spans"] = rep
    return out


def span_read_trace(read_trace, path, wall_s, *, kept: dict) -> dict:
    """``read_trace(path, wall_s)`` (the harness's ``_read_trace``, which
    deletes the trace) with the trace's gaps and base time and the spans
    drained now added; the spans, their alignment with the trace and the
    context are also left in ``kept``."""
    import pb_spans
    from repro_torch import spans

    with open(path) as f:
        tr = json.load(f)
    out = read_trace(path, wall_s)
    kept["spans"], kept["anchor"] = spans.drain()
    base = pb_spans.base_ns(tr)
    out.update(gaps=pb_spans.trace_gaps(tr["traceEvents"]),
               trace_base_ns=base, spans=kept["spans"],
               span_anchor=kept["anchor"])
    kept["alignment"] = alignment(tr["traceEvents"], kept["spans"],
                                  kept["anchor"], base)
    kept["ctx"] = out
    return out


def _ms(s) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def _stats(xs: list[float]) -> dict:
    if not xs:
        return {"n": 0}
    return {"n": len(xs), "min": min(xs), "median": statistics.median(xs),
            "max": max(xs), "total": sum(xs)}


def alignment(events: list[dict], recorded: list, anchor, base: int) -> dict:
    """How the program's spans sit on the profiler's trace: each
    ``pb.place_many`` range (opened by ``pb_capture`` on the main thread,
    inside the program's ``serve.place``) against the ``serve.place`` span
    around it, in us (``start``: range start less span start; ``end``: span
    end less range end; both small and positive when the clocks agree),
    and the trace's ``cudaGraphLaunch`` calls that lie inside an
    ``exec.launch`` span of their own thread (``pb_spans.trace_tids``), with
    how far inside: a clock offset larger than the smallest of these
    margins would put a call outside its span."""
    import pb_spans

    def us(ns):
        return pb_spans.to_trace_us(anchor, base, ns)

    place = [(us(s.start_ns), us(s.end_ns), s.tid) for s in recorded
             if s.name == "serve.place"]
    launch: dict = {}
    for s in recorded:
        if s.name == "exec.launch":
            for tid in pb_spans.trace_tids(s):
                launch.setdefault(tid, []).append((us(s.start_ns),
                                                   us(s.end_ns)))
    starts, ends, inside, graph_launches = [], [], 0, 0
    before, after = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if e.get("cat") == "user_annotation" and e["name"] == "pb.place_many":
            mid = (a + b) / 2
            near = min(place, key=lambda p: abs((p[0] + p[1]) / 2 - mid),
                       default=None)
            if near is not None:
                starts.append(a - near[0])
                ends.append(near[1] - b)
        elif e.get("cat") == "cuda_runtime" and e["name"] == "cudaGraphLaunch":
            graph_launches += 1
            for s, t in launch.get(e.get("tid"), []):
                if s <= a and b <= t:
                    inside += 1
                    before.append(a - s)
                    after.append(t - b)
                    break
    return {"place_start_us": _stats(starts), "place_end_us": _stats(ends),
            "graph_launches": graph_launches,
            "graph_launches_in_exec_launch": inside,
            "launch_after_span_start_us": _stats(before),
            "launch_before_span_end_us": _stats(after)}


def cold_vs_record(recorded: list, execs: list) -> dict:
    """Each cold execution of the warm-up and the window
    (``Capture.execs``) against the ``cold`` span of its executor: the largest |span - start_ms| over
    start_ms, and the cold executions found without a span."""
    cold = {s.attrs.get("seed"): _ms(s) for s in recorded if s.name == "cold"}
    rel, missing = [], 0
    for e in execs:
        if not e.record.cold:
            continue
        if e.seed not in cold:
            missing += 1
            continue
        rel.append(abs(cold[e.seed] - e.record.start_ms)
                   / max(e.record.start_ms, 1e-9))
    return {"cold_execs": len(rel) + missing, "without_span": missing,
            "max_rel_diff": max(rel, default=None)}


def setup_split(recorded: list, t_start: float, warmup_slices: int) -> dict:
    """Set-up by span: the kernels' build, calibration (cold starts, warm
    measurements, fits), the pool, the edge executor's re-seeded cold start
    and the warm-up slices, in seconds; ``until_window_s`` from the
    process's start to the first slice of the window; and the cold starts
    before the window and in it, part by part, in ms."""
    slices = [s for s in recorded if s.name == "serve.slice"]
    window_ns = slices[warmup_slices].start_ns \
        if len(slices) > warmup_slices else None
    out = {}
    for name in ("kernels.build", "calibrate", "calibrate.cold",
                 "calibrate.warm", "calibrate.fit", "pool.make"):
        out[name] = sum(_ms(s) for s in recorded if s.name == name) / 1e3
    out["edge_reseed"] = sum(_ms(s) for s in recorded
                             if s.name == "exec" and s.parent == 0) / 1e3
    out["warmup_slices"] = sum(_ms(s) for s in slices[:warmup_slices]) / 1e3
    if window_ns is not None:
        out["until_window_s"] = window_ns / 1e9 - t_start
    totals: dict = {"before_window_s": {}, "in_window_s": {}}
    for s in recorded:
        when = "before_window_s" if window_ns is None \
            or s.start_ns < window_ns else "in_window_s"
        totals[when][s.name] = totals[when].get(s.name, 0.0) + _ms(s) / 1e3
    out.update(totals)
    # calibration's warm executions by executor: seed 7 the slices', 0 the
    # edge's
    cal = {s.id for s in recorded if s.name == "calibrate.warm"}
    by_seed: dict = {}
    for s in recorded:
        if s.name == "exec" and s.parent in cal:
            key = str(s.attrs.get("seed"))
            by_seed[key] = by_seed.get(key, 0.0) + _ms(s) / 1e3
    out["calibrate_exec_s_by_seed"] = by_seed
    # the main thread's top-level spans before the window, in seconds from
    # the process's start
    out["timeline"] = [[s.name, s.start_ns / 1e9 - t_start,
                        s.end_ns / 1e9 - t_start] for s in recorded
                       if s.parent == 0 and (window_ns is None
                                             or s.start_ns < window_ns)]
    for when in ("before_window", "in_window"):
        out[when] = {name: _stats([
            _ms(s) for s in recorded if s.name == name
            and (window_ns is None or (s.start_ns < window_ns)
                 == (when == "before_window"))]) for name in COLD_PARTS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch

    import pb_common as pc
    import pb_harness

    entry = pc.cell_entry(pc.benchmark(), args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        pc.log(f"{args.workload} needs {entry['chips']} CUDA card(s); "
               f"{torch.cuda.device_count()} available")
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              bool(args.spans), t_start=T0)
    found = pb_harness.forbidden_modules()
    if found:
        pc.log(f"the process holds {', '.join(found)} after the window: the "
               "program under test must not load JAX or the JAX package")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
