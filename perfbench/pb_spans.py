"""The program's own spans (``repro_torch.spans``) read against the
profiler's trace of the card: each idle gap of the traced stretch put down
to the layer whose host work held the card back, and set-up split by span.

What a run adds to the metric readers' context, beside ``_read_trace``'s
keys:

- ``gaps``: every gap between the union of kernel intervals, as
  (start us, end us, the trace's ``tid`` of the thread that launched the
  kernel that ends it, or None, and that kernel's name), in the trace's
  ``ts`` units (``trace_gaps``; ``trace_tids`` matches a span's thread to
  that tid);
- ``trace_base_ns``: the trace's ``baseTimeNanoseconds``;
- ``spans``, ``span_anchor``: what ``repro_torch.spans.drain`` returned.

The idle gaps (``idle_split``): a gap shorter than ``SHORT_GAP_US`` lies
between the kernels of one graph replay. Every longer one goes to the
innermost span open at its middle on the thread that launched the kernel
that ends it (the profiler links a kernel to its runtime call by
correlation id): ``exec.launch`` is the steps' (the host replaying graphs
more slowly than the card runs them), any other span under
``pool.dispatch`` the executor pool's (lease, lock, cold start, feed,
sync, store, land), and everything else, with the idle before the first
kernel and after the last, the serve loop's. The four shares add up to
``idle_pct``.
"""

from __future__ import annotations

import bisect

from pb_harness import SHORT_GAP_US

LAUNCH, POOL, SERVE, SHORT = "launch", "pool", "serve", "short"


def trace_gaps(events: list[dict]) -> list[tuple]:
    """The gaps between the union of the kernel intervals of a chrome
    trace's events (kernels taken and merged as ``_read_trace`` takes and
    merges them), each with the launching thread of the kernel that ends
    it."""
    kernels, launcher = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "kernel":
            kernels.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                            e["name"], corr))
        elif cat == "cuda_runtime" and corr is not None:
            launcher[corr] = e.get("tid")
    kernels.sort(key=lambda k: k[:3])
    gaps = []
    cur_e = None
    for s, e, name, corr in kernels:
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s, launcher.get(corr), name))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def base_ns(trace: dict) -> int:
    return int(trace.get("baseTimeNanoseconds", 0))


def to_trace_us(anchor, base: int, perf_ns: int) -> float:
    """A span time (``perf_counter_ns``) in the trace's ``ts`` units."""
    return (anchor.wall_ns(perf_ns) - base) / 1e3


def trace_tids(s) -> set:
    """The ``tid``s a ``torch.profiler`` chrome trace may give the host
    events of span ``s``'s thread: its native id, which the trace gives the
    threads whose host ops it records (the main thread), and, for the CUDA
    runtime calls of the other threads, the thread's pthread id as the
    profiler reports it (its low 32 bits as a signed int32, written as a
    magnitude; seen on the card for one positive and one negative value)."""
    low = s.ident & 0xFFFFFFFF
    return {s.tid, abs(low - (1 << 32) if low & 0x80000000 else low)}


def has_spans(ctx: dict) -> bool:
    return bool(ctx.get("spans")) and ctx.get("span_anchor") is not None


def idle_split(ctx: dict) -> dict | None:
    """Idle seconds of the traced stretch by bucket (``launch``, ``pool``,
    ``serve``, ``short``), with ``unlinked``: the gaps of 20 us or more
    whose kernel the trace gives no launching thread (counted as the serve
    loop's), and the seconds of those gaps by the innermost span
    (``by_span``) and by the kernel that ends them (``by_kernel``, the ten
    largest). Kept in ``ctx`` once worked out."""
    if "idle_split" in ctx:
        return ctx["idle_split"]
    if not (has_spans(ctx) and ctx.get("kernels_seen") and "gaps" in ctx):
        return None
    anchor, base = ctx["span_anchor"], ctx["trace_base_ns"]
    gaps = ctx["gaps"]
    lo = min((g[0] for g in gaps), default=0.0)
    hi = max((g[1] for g in gaps), default=0.0)
    by_id = {s.id: s for s in ctx["spans"]}
    # the spans of each thread that overlap the gaps, by start
    per_tid: dict[int, list] = {}
    for s in ctx["spans"]:
        a = to_trace_us(anchor, base, s.start_ns)
        b = to_trace_us(anchor, base, s.end_ns)
        if b >= lo and a <= hi:
            for tid in trace_tids(s):
                per_tid.setdefault(tid, []).append((a, b, s))
    for lst in per_tid.values():
        lst.sort(key=lambda t: (t[0], t[2].id))
    starts = {tid: [t[0] for t in lst] for tid, lst in per_tid.items()}

    out = {LAUNCH: 0.0, POOL: 0.0, SERVE: 0.0, SHORT: 0.0, "unlinked": 0,
           "gaps_attributed": 0}
    by_span: dict[str, float] = {}
    by_kernel: dict[str, float] = {}
    for s, e, tid, kernel in gaps:
        dur = (e - s) / 1e6
        if e - s < SHORT_GAP_US:
            out[SHORT] += dur
            continue
        out["gaps_attributed"] += 1
        if tid is None:
            out["unlinked"] += 1
        mid = (s + e) / 2
        inner = None
        lst = per_tid.get(tid, [])
        for a, b, sp in lst[:bisect.bisect_right(starts.get(tid, []), mid)]:
            if b >= mid:
                inner = sp  # later starts are nested deeper
        out[_bucket(inner, by_id)] += dur
        where = inner.name if inner is not None else "none"
        by_span[where] = by_span.get(where, 0.0) + dur
        by_kernel[kernel] = by_kernel.get(kernel, 0.0) + dur
    out[SERVE] += max(ctx["trace_window_s"] - ctx["device_span_s"], 0.0)
    out["by_span"] = by_span
    out["by_kernel"] = dict(sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1])[:10])
    ctx["idle_split"] = out
    return out


def _bucket(inner, by_id: dict) -> str:
    if inner is None:
        return SERVE
    if inner.name == "exec.launch":
        return LAUNCH
    s = inner
    while s is not None:
        if s.name == "pool.dispatch":
            return POOL
        s = by_id.get(s.parent)
    return SERVE


def idle_pct(ctx: dict, bucket: str) -> float | None:
    split = idle_split(ctx)
    if split is None:
        return None
    return 100.0 * split[bucket] / ctx["trace_window_s"]


def durations_ms(ctx: dict, name: str) -> list[float]:
    """The milliseconds of every span named ``name`` the run recorded."""
    if not has_spans(ctx):
        return []
    return [(s.end_ns - s.start_ns) / 1e6 for s in ctx["spans"]
            if s.name == name]
