"""One run of one cell: set-up, the measured window, the check, the result.

In order, a run

1. builds or loads the port's kernels (``build/kernels/`` in the checkout);
2. calibrates the slice catalog (``calibrate_catalog``) on real executions;
3. builds the live runtime (``make_live_runtime``) and seeds its executors
   from ``--seed``;
4. warms the pool by serving the first slices of the seeded stream;
5. serves consecutive slices of that stream through
   ``PlacementRuntime.serve_async`` for ``--seconds`` (the window ends at the
   first slice boundary after it), keeping one runtime throughout, so the
   edge queue, the container pool and the virtual clock carry over;
6. reads the peak memory, frees the program's state and checks what the
   window served against the plain references (``pb_check``);
7. returns the result line (``run.py`` prints it, unless the process then
   holds JAX or the JAX package).

With ``--trace 1`` a fixed stretch of the window (``window.trace_slices``) is
traced with ``torch.profiler`` and the per-layer metrics are reported
instead of the end-to-end ones.
"""

from __future__ import annotations

import gc
import json
import math
import os
import sys
import time
from pathlib import Path

import pb_check
import pb_common as pc
from pb_capture import Capture

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the sources of the kernels a serving executor and the decision engine
# launch (the predictor's trees, prefill and decode attention, the SSD scan)
# idle gaps shorter than this lie between the kernels of one graph replay
SHORT_GAP_US = 20.0
SERVING_KERNELS = ("gbrt_predict", "flash_attention", "decode_attention",
                   "ssd_scan")


def program_config(fields: dict):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(**fields)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def slices(traffic: dict, seed: int, per_slice: int):
    """Consecutive slices of ``per_slice`` tasks of the cell's stream."""
    from repro_torch.core.workload import TaskInput

    gen = pc.traffic_module(traffic["kind"]).stream(traffic, seed)
    i = 0
    while True:
        out = []
        for _ in range(per_slice):
            t, n, nb = next(gen)
            out.append(TaskInput(idx=i, arrival_ms=t, size=float(n),
                                 bytes=nb))
            i += 1
        yield out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             config_overrides: dict | None = None,
             workload_overrides: dict | None = None,
             program_hook=None, keep: dict | None = None,
             control: str | None = None, stats: dict | None = None,
             log=pc.log) -> dict:
    """One run of ``cell``; returns the result line as a dict.
    ``config_overrides`` and ``workload_overrides`` shrink a cell for the
    CPU tests; ``program_hook(runtime)`` may break the program under test
    (the planted faults). ``keep`` carries the calibrated catalog from one
    call to the next (``keep["cat"]``), for many seeds or rates in one
    process. ``control`` (a precision of ``reference/_common.py``'s
    ``Prec``) puts the reference in that precision in the place of the
    program's outputs for the check, so the run must come out not correct;
    the largest readings of both sides are added under ``readings``.
    ``stats``, where given, receives the pool's counters, each execution's
    queue wait in the order they finished, the window's records and its
    seconds (for the rate sweep)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = pc.benchmark()
    entry = pc.cell_entry(bench, cell)
    cfg_file = pc.load_config(entry["config"])
    prog = {**cfg_file["program"], **(config_overrides or {})}
    wl = pc.load_workload(cell)
    for k, v in (workload_overrides or {}).items():
        wl[k] = {**wl.get(k, {}), **v}
    on_card = device == "cuda"

    from repro_torch.core.decision import MinLatencyPolicy
    from repro_torch.serving import SliceSpec, calibrate_catalog, make_live_runtime

    if on_card:
        from repro_torch.kernels import _build

        _build.build_all(SERVING_KERNELS)
        torch.cuda.reset_peak_memory_stats()
    cfg = program_config(prog)
    cap = Capture()
    cap.install()
    try:
        srv, cal, win = wl["serve"], wl["calibration"], wl["window"]
        specs = [SliceSpec(f"slice{c}", c) for c in srv["slices"]]
        keep = {} if keep is None else keep
        if "cat" not in keep:
            keep["cat"] = calibrate_catalog(
                cfg, specs, n_tasks=cal["n_tasks"], n_cold=cal["n_cold"],
                seed=seed % 2**32, mean_tokens=cal["mean_tokens"],
                device=device)
        cat = keep["cat"]
        pol = srv["policy"]
        rt = make_live_runtime(cat, MinLatencyPolicy(pol["c_max"],
                                                     pol["alpha"]),
                               t_idl_ms=srv["t_idl_ms"], device=device)
        pool = rt.backend.pool
        # the executors' weights come from --seed: the pool's containers
        # take base + 1, base + 2, ...; the edge executor takes base and
        # starts again from it
        base = (seed % 2**40) << 16
        pool._seed = base
        for ex in pool.edges.values():
            ex.seed = base
            ex.evict()
            ex.execute(1, 4.0)
        cap.wrap_engine(rt.engine)
        if program_hook is not None:
            program_hook(rt)
        stream = slices(wl["traffic"], seed, win["slice_tasks"])
        served = []  # (tasks, result) per slice, warm-up included
        for _ in range(win["warmup_slices"]):
            tasks = next(stream)
            served.append((tasks, rt.serve_async(tasks)))
        if on_card:
            torch.cuda.synchronize()
        cap.reset()
        n_warm = len(served)
        setup_s = time.perf_counter() - t_start
        log(f"[perfbench] {cell}: set-up {setup_s:.2f} s; window "
            f"{seconds} s of slices of {win['slice_tasks']} tasks")

        prof = None
        trace_from, trace_to = win["trace_slices"]
        t0 = time.perf_counter()
        k = 0
        while True:
            if trace and k == trace_from:
                prof = _start_profiler(cap)
                t_trace = time.perf_counter()
            tasks = next(stream)
            served.append((tasks, rt.serve_async(tasks)))
            k += 1
            if prof is not None and k == trace_to:
                trace_s = time.perf_counter() - t_trace
                trace_path = _stop_profiler(prof, cap)
                prof = None
            if time.perf_counter() - t0 >= seconds and prof is None:
                break
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        window = served[n_warm:]
        records = _records(window)
        catalog = pb_check.catalog_numbers(cat, rt, specs)
        pool_stats = {"cap": pool.max_resident,
                      "peak_resident": pool.peak_resident,
                      "cap_waits": pool.cap_waits,
                      "reclaimed": pool.reclaimed,
                      "most_cold_starts_at_once": cap.cold_most}
        execs = cap.execs
        place = (cap.place_s, cap.place_tasks)
        inputs = dict(cap.inputs)
    finally:
        cap.uninstall()
    all_tasks = [(t.arrival_ms, t.size, t.bytes)
                 for tasks, _ in served for t in tasks]
    prog_rows = _records(served)
    # free the program's state before the reference runs on the card
    for lst in pool.containers.values():
        for ex in lst:
            ex.evict()
    for ex in pool.edges.values():
        ex.evict()
    for e in execs:
        if e.logits is not None:
            e.logits = e.logits.cpu()
        if e.kv is not None:
            e.kv = e.kv.cpu()
    del rt, pool, cat, served
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks, readings = pb_check.check(
        prog=prog, config_name=entry["config"], wl=wl, seed=seed, catalog=catalog,
        all_tasks=all_tasks, prog_rows=prog_rows, window_rows=records,
        execs=execs, inputs=inputs, device=device, control=control, log=log)
    correct = all(c["ok"] for c in checks.values())

    n = len(records["latency_ms"])
    failed = int(records["failed"].sum())
    ctx = {"cell": cell, "entry": entry, "cfg": prog,
           "family": prog["family"],
           "prompt_len": len(next(iter(inputs.values()))[0]),
           "records": records, "execs": execs, "place": place,
           "pool": pool_stats, "window_s": window_s}
    if trace:
        ctx.update(_read_trace(trace_path, trace_s))
        metrics = {}
        for m in pc.metrics_of(bench, "per_layer", cell):
            v = pc.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        lat = records["latency_ms"]
        values = {
            "avg_latency_ms": pc.mean(lat),
            "p95_latency_ms": pc.percentile(lat, 95),
            "tasks_per_s": n / window_s,
            "usd_per_ktask": math.fsum(records["cost"]) / n * 1000.0,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in pc.metrics_of(bench, "end_to_end", cell)}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": entry["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": n, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx["busy_s"]
        dev["window_s"] = ctx["trace_window_s"]
        out["breakdown"] = ctx["breakdown"]
    log(f"[perfbench] {cell}: {n} tasks in {window_s:.2f} s, pool "
        f"{json.dumps(pool_stats)}, peak {peak / 2**30:.2f} GiB")
    if control:
        out["readings"] = {side: {k: float(max(v)) for k, v in
                                  readings[side].items() if v}
                           for side in ("served", control)}
    if stats is not None:
        stats.update(pool=pool_stats, records=records, window_s=window_s,
                     peak_bytes=int(peak),
                     queue_ms=[e.record.queue_ms for e in
                               sorted(execs, key=lambda e: e.t_end)])
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def _records(served) -> dict:
    """The window's records as columns, in serving order."""
    import numpy as np

    cols = {"latency_ms": [], "predicted_ms": [], "cost": [],
            "predicted_cost": [], "target": [], "queue_ms": [], "cold": [],
            "predicted_cold": [], "allowed": [], "failed": [], "arrival": [],
            "tokens": [], "exec_ms": []}
    for tasks, res in served:
        r = res.records
        names = list(r.target_names)
        cols["target"] += [names[c] for c in np.asarray(r.target_codes)]
        cols["latency_ms"].append(np.asarray(r.actual_latency_ms, float))
        cols["predicted_ms"].append(np.asarray(r.predicted_latency_ms, float))
        cols["cost"].append(np.asarray(r.actual_cost, float))
        cols["predicted_cost"].append(np.asarray(r.predicted_cost, float))
        cols["queue_ms"].append(np.asarray(r.queue_wait_ms, float))
        cols["exec_ms"].append(np.asarray(r.exec_ms, float))
        cols["cold"].append(np.asarray(r.actual_cold, bool))
        cols["predicted_cold"].append(np.asarray(r.predicted_cold, bool))
        cols["allowed"].append(np.asarray(r.allowed_cost, float))
        bad = np.zeros(len(tasks), bool)
        for extra in (r.failed, r.shed):
            if extra is not None:
                bad |= np.asarray(extra, bool)
        if len(r.actual_latency_ms) != len(tasks):
            raise RuntimeError(f"a slice of {len(tasks)} tasks came back with "
                               f"{len(r.actual_latency_ms)} records")
        cols["failed"].append(bad)
        cols["arrival"].append(np.array([t.arrival_ms for t in tasks]))
        cols["tokens"].append(np.array([t.size for t in tasks]))
    out = {k: (np.concatenate(v) if k != "target" else v)
           for k, v in cols.items()}
    return out


def _start_profiler(cap: Capture):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    cap.annotate = cap.tracing = True
    return prof


def _stop_profiler(prof, cap: Capture) -> Path:
    import torch

    torch.cuda.synchronize()
    cap.annotate = cap.tracing = False
    prof.__exit__(None, None, None)
    tmp = Path(os.environ.get("TMPDIR") or "/tmp")
    path = tmp / f"perfbench-trace-{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    return path


def _read_trace(path: Path, wall_s: float) -> dict:
    """Kernels and host calls of the traced stretch: the device's busy
    seconds (the union of kernel intervals), the kernels by name, the idle
    gaps by the host call open at their middle (the innermost CUDA runtime
    call or harness range on any thread; the profiler records the harness's
    ranges on the main thread only)."""
    import pb_roofline

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    path.unlink()
    kernels, ranges = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "kernel":
            kernels.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                            e["name"]))
        elif cat == "cuda_runtime" or (cat == "user_annotation"
                                       and e["name"].startswith("pb.")):
            ranges.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           e["name"]))
    kernels.sort()
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    span_us = (cur_e - kernels[0][0]) if kernels else 0.0
    by_name: dict[str, float] = {}
    count: dict[str, int] = {}
    for s, e, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        count[name] = count.get(name, 0) + 1
    gap_by: dict[str, float] = {}
    for s, e in gaps:
        if e - s < SHORT_GAP_US:
            label = f"gaps under {SHORT_GAP_US:g} us between kernels"
        else:
            mid = (s + e) / 2
            over = [r for r in ranges if r[0] <= mid <= r[1]]
            label = min(over, key=lambda r: r[1] - r[0])[2] if over \
                else "host outside CUDA calls"
        gap_by[label] = gap_by.get(label, 0.0) + (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gap_by.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "trace_window_s": wall_s,
            "kernel_s": by_name,
            "kernel_n": count,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in idle]},
            "kernels_seen": bool(kernels), "device_span_s": span_us / 1e6,
            "roofline": pb_roofline}
