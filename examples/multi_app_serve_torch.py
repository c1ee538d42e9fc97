"""Cross-application streaming serve on the PyTorch port: IR + FD + STT as
parallel shards.

The counterpart of ``examples/multi_app_serve.py``, through ``repro_torch``
only, on the CUDA card by default (where every prediction pass of 4,096
rows or more runs the GBRT kernel K2). The paper evaluates each application
in isolation; real edge platforms run long-lived mixes (EdgeBench's trio).
This example:

1. streams ONE application through ``PlacementRuntime.serve_stream`` and
   shows the parity guarantee — the chunked result is bit-identical to the
   one-shot ``serve(batched=True)``, at O(chunk) working memory;
2. serves all three applications as ``AppShard``s through ``serve_sharded``
   — each shard owns its fitted Predictor, its policy budget, and its own
   3-device fleet partition — and prints the cross-app report.

    PYTHONPATH=src python examples/multi_app_serve_torch.py
    PYTHONPATH=src python examples/multi_app_serve_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.decision import DecisionEngine, MinLatencyPolicy
from repro_torch.core.fit import build_fleet_predictor, fit_app
from repro_torch.core.multiapp import AppShard, serve_sharded
from repro_torch.core.runtime import PlacementRuntime, TwinBackend

CONFIGS = (1280, 1536, 1792)
FLEET = {"edge0": 1.0, "edge1": 1.0, "edge2": 0.6}
APPS = ("IR", "FD", "STT")
N_PER_APP = 100_000
CHUNK = 16_384
N_PARITY = 20_000
PARITY_CHUNK = 1024


def _setups() -> dict:
    return {app: fit_app(app, seed=0, n_inputs=120, configs=CONFIGS)
            for app in APPS}


def make_runtime(setups: dict, device, app: str,
                 c_max: float = 0.0) -> PlacementRuntime:
    twin, models = setups[app]
    pred = build_fleet_predictor(models, dict(FLEET), configs=CONFIGS)
    eng = DecisionEngine(predictor=pred,
                         policy=MinLatencyPolicy(c_max=c_max, alpha=0.0),
                         device=device)
    backend = TwinBackend(twin, seed=7, edge_names=tuple(FLEET),
                          edge_speed=FLEET)
    return PlacementRuntime(eng, backend)


def make_workload(setups: dict, app: str, n: int, chunk: int):
    # a generator of columnar TaskChunks: O(chunk) live tasks, bit-identical
    # to the list the same workload's generate(n) would build
    return setups[app][0].poisson(seed=3).chunks(n, chunk_size=chunk)


def run(device=None, *, n_per_app: int = N_PER_APP, chunk: int = CHUNK,
        n_parity: int = N_PARITY, log=None) -> dict:
    """The streaming parity check, then the three apps as shards served
    sequentially and in threads; returns both, the sharded results, the
    wall times and, under ``"headline"``, the printed numbers."""
    dev = resolve_device(device)
    say = log or (lambda *_: None)
    setups = _setups()
    runtime = functools.partial(make_runtime, setups, dev)

    # ---- 1. streaming parity: chunked ≡ one-shot, per record --------------
    tasks = setups["STT"][0].workload(n_parity, seed=3)
    one = runtime("STT").serve(tasks, batched=True)
    streamed = runtime("STT").serve_stream(tasks, chunk_size=PARITY_CHUNK)
    assert list(streamed.records.targets) == list(one.records.targets)
    assert np.array_equal(streamed.records.actual_latency_ms,
                          one.records.actual_latency_ms)
    assert np.array_equal(streamed.records.completion_ms,
                          one.records.completion_ms)
    say(f"serve_stream(chunk={PARITY_CHUNK}) ≡ serve(batched=True): "
        f"{streamed.n:,} records identical\n")

    # ---- 2. the cross-application fleet ----------------------------------
    shards = [AppShard(name=app,
                       runtime=functools.partial(runtime, app),
                       workload=functools.partial(make_workload, setups, app,
                                                  n_per_app, chunk),
                       chunk_size=chunk)
              for app in APPS]
    t0 = time.perf_counter()
    seq = serve_sharded(shards, parallel=False)
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    par = serve_sharded(shards)  # threads; use_processes=True for isolation
    par_s = time.perf_counter() - t0

    for app in APPS:  # independent shards: scheduling perturbs nothing
        assert np.array_equal(par.results[app].records.actual_latency_ms,
                              seq.results[app].records.actual_latency_ms)

    say(f"3 apps × {n_per_app:,} tasks   sequential {seq_s:.2f}s   "
        f"parallel {par_s:.2f}s\n")
    say(par.table())
    say("\nper-app stream stats:")
    for app, st in par.stream_stats.items():
        say(f"  {app:<4} {st}")
    return {"one_shot": one, "streamed": streamed, "sequential": seq,
            "parallel": par, "sequential_s": seq_s, "parallel_s": par_s,
            "headline": {"sequential_s": seq_s, "parallel_s": par_s,
                         "shard_launches": {
                             a: st["launches"]
                             for a, st in par.stream_stats.items()}}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    run(args.device, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
