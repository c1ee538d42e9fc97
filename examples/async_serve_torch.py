"""Async serving on the PyTorch port: the event-driven driver on the live
pool and on the twin.

The counterpart of ``examples/async_serve.py``, through ``repro_torch``
only, on the CUDA card by default.

Part 1 — the LIVE pool: ``serve_async`` over real executors runs a
genuinely concurrent dispatch loop (one worker thread per edge device and
per cloud config, completion queue, per-executor cold-start guard). With the
paper's WAN legs emulated as real waits (``NetworkProfile``), the per-device
workers overlap each other's network time and the wall clock drops well
below sequential dispatch. (This part runs first: it measures real wall
time, and the cleanest process state gives the fairest overlap numbers.)
On the card each executor's prefill and decode steps launch the attention
kernels K4 and K5 (eagerly at a cold start, then from CUDA graphs); ``cfg``
may be any config the executors serve, the full-width llama3.2-1b included.

Part 2 — the TWIN: the same ``serve_async`` call fans a bursty 3-device
fleet workload out to per-target workers interleaved on the virtual-clock
event heap (``repro_torch.core.events``) and merges the outcome arrays back
into the same columnar ``RecordBatch`` as ``serve(batched=True)``. The two
results are METRIC-IDENTICAL — that is the parity guarantee the
event-driven refactor ships with (the heap changes *when* work is
simulated, never the math). On the card the 5,000-row prediction pass runs
the GBRT kernel K2.

    PYTHONPATH=src python examples/async_serve_torch.py
    PYTHONPATH=src python examples/async_serve_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.core.decision import DecisionEngine, MinLatencyPolicy
from repro_torch.core.fit import build_fleet_predictor, fit_app
from repro_torch.core.runtime import PlacementRuntime, TwinBackend
from repro_torch.core.workload import BurstyWorkload
from repro_torch.serving.executors import NetworkProfile, SliceSpec
from repro_torch.serving.placement import (
    calibrate_catalog,
    llm_workload,
    make_live_runtime,
)

CONFIGS = (1280, 1536, 1792)
DEVICES = {"edge0": 1.0, "edge1": 1.0, "edge2": 0.6}
N_REQUESTS = 60
RATE_PER_S = 2000.0
MEAN_TOKENS = 16.0
N_TWIN = 5000


def toy_config():
    """The reference's 32-wide two-layer llama3.2-1b reduction."""
    return smoke_config("llama3.2-1b").with_updates(
        n_layers=2, d_model=32, d_ff=64, vocab=64, n_heads=2, n_kv_heads=2,
        head_dim=16)


def live_overlap(dev, cfg, n_requests: int, say) -> dict:
    """Part 1: the same requests through ``serve`` and ``serve_async`` on
    two live runtimes provisioned before the timers."""
    say("calibrating the live catalog (real cold starts)...")
    cat = calibrate_catalog(cfg, [SliceSpec("s2", 2, tokens_per_step=4),
                                  SliceSpec("s8", 8, tokens_per_step=4)],
                            n_tasks=6, n_cold=1, seed=0,
                            mean_tokens=MEAN_TOKENS, device=dev)
    requests = llm_workload(n_requests, rate_per_s=RATE_PER_S, seed=4,
                            mean_tokens=MEAN_TOKENS)
    net = NetworkProfile(base_ms=40.0)  # the paper's IoT-upload leg, emulated

    def live():
        return make_live_runtime(cat, MinLatencyPolicy(c_max=0.0, alpha=0.0),
                                 n_edge_devices=3, network=net, device=dev)

    # provision (and build) both fleets BEFORE the timers: the comparison is
    # dispatch overlap, not provisioning cost
    rt_seq, rt_async = live(), live()

    t0 = time.perf_counter()
    seq = rt_seq.serve(requests)
    seq_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = rt_async.serve_async(requests)
    async_s = time.perf_counter() - t0

    say(f"live: sequential {seq_s:5.2f}s   async {async_s:5.2f}s   "
        f"overlap speedup {seq_s / async_s:4.2f}x")
    say(res.device_table())
    return {"catalog": cat, "sequential": seq, "async": res,
            "runtime_async": rt_async, "sequential_s": seq_s,
            "async_s": async_s, "speedup": seq_s / async_s,
            "n_requests": n_requests}


def twin_parity(dev, n_tasks: int, say) -> dict:
    """Part 2: ``serve_async`` against ``serve(batched=True)`` on the
    twin."""
    say("\nfitting FD models...")
    twin, models = fit_app("FD", seed=0, n_inputs=150, configs=CONFIGS)
    tasks = BurstyWorkload(rate_per_s=4.0, size_sampler=twin.sample_input,
                           burst_multiplier=6.0, mean_quiet_s=15.0,
                           mean_burst_s=6.0, seed=7).generate(n_tasks)

    def runtime():
        eng = DecisionEngine(
            predictor=build_fleet_predictor(models, dict(DEVICES),
                                            configs=CONFIGS),
            policy=MinLatencyPolicy(c_max=1e-5, alpha=0.02), device=dev)
        return PlacementRuntime(eng, TwinBackend(twin, seed=11,
                                                 edge_names=tuple(DEVICES),
                                                 edge_speed=dict(DEVICES)))

    batched = runtime().serve(tasks)

    rt = runtime()
    # the per-target worker queues the async driver consumes, by
    # target_codes
    plan = rt.engine.place_many(tasks, edge_queues=rt.edge_queues)
    workers = {}
    for name, rows in sorted(plan.rows_by_target().items()):
        workers[name] = int(rows.shape[0])
        say(f"  worker {name:<6} pulls {rows.shape[0]:>5} rows")
    event_driven = runtime().serve_async(tasks)

    assert event_driven.total_actual_cost == batched.total_actual_cost
    assert event_driven.avg_actual_latency_ms == batched.avg_actual_latency_ms
    assert event_driven.p99_actual_latency_ms == batched.p99_actual_latency_ms
    say(f"twin parity: serve_async == serve(batched=True)  "
        f"(mean {event_driven.avg_actual_latency_ms:,.0f} ms, "
        f"p99 {event_driven.p99_actual_latency_ms:,.0f} ms, "
        f"cost ${event_driven.total_actual_cost:.4f})")
    return {"batched": batched, "event_driven": event_driven,
            "workers": workers}


def run(device=None, *, cfg=None, n_requests: int = N_REQUESTS,
        n_twin: int = N_TWIN, log=None) -> dict:
    """Part 1 on ``cfg`` (default: the reference's toy config), then part 2;
    returns both parts' results and numbers under ``"live"`` and
    ``"twin"``, and the printed numbers under ``"headline"``."""
    dev = resolve_device(device)
    say = log or (lambda *_: None)
    live = live_overlap(dev, cfg if cfg is not None else toy_config(),
                        n_requests, say)
    twin = twin_parity(dev, n_twin, say)
    res = live["async"]
    return {"live": live, "twin": twin, "headline": {
        "served": res.n, "failed": res.n_failed, "shed": res.n_shed,
        "async_avg_ms": res.avg_actual_latency_ms,
        "async_p95_ms": res.p95_actual_latency_ms,
        "sequential_avg_ms": live["sequential"].avg_actual_latency_ms,
        "sequential_s": live["sequential_s"], "async_s": live["async_s"],
        "speedup": live["speedup"],
        "twin_mean_ms": twin["event_driven"].avg_actual_latency_ms,
        "twin_workers": twin["workers"]}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    run(args.device, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
