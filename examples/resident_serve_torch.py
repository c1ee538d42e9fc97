"""Device-resident placement on the PyTorch port: the torch predict→place
pipeline against the numpy oracle.

The counterpart of ``examples/jax_serve.py``, through ``repro_torch`` only,
on the CUDA card by default. Serves the same bursty stream through the
numpy columnar oracle (on the CPU) and through ``array_backend="torch"`` on
the device, and verifies the parity contract on the spot: on the CPU the
torch backend must match the oracle bit-for-bit on every record column; on
the card it must make identical decisions with floats within 1e-9 (the
GBRT step tables, the walk and the replay are hand-written kernels there:
K1, K3, ``state_walk``, ``state_replay``).

Then demonstrates persistent residency: a 3-chunk resident stream places
every chunk with the CIL pools / surplus bank / edge horizons held on the
device (one host materialization total, at stream end), matches the
oracle's decisions, and — rerun same-shape on the same engine — regrows no
pool, keeps its placement core and builds no kernel library again.

    PYTHONPATH=src python examples/resident_serve_torch.py
    PYTHONPATH=src python examples/resident_serve_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import torch_core
from repro_torch.core.decision import DecisionEngine, MinLatencyPolicy
from repro_torch.core.fit import build_fleet_predictor, fit_app
from repro_torch.core.runtime import PlacementRuntime, TwinBackend
from repro_torch.core.workload import BurstyWorkload
from repro_torch.kernels import _build

N_TASKS = 2_000
CHUNK = 512
CONFIGS = (1280, 1536, 1792)
FLEET = {"edge0": 1.0, "edge1": 1.0, "edge2": 0.6}
C_MAX = 6e-6            # $/task budget (Alg. 1)
ALPHA = 0.05

COLS = ("predicted_latency_ms", "predicted_cost", "actual_latency_ms",
        "actual_cost", "allowed_cost", "completion_ms", "queue_wait_ms",
        "exec_ms", "predicted_cold", "actual_cold", "feasible")


def run(device=None, *, n_tasks: int = N_TASKS, chunk: int = CHUNK,
        log=None) -> dict:
    """Serve the stream through the numpy oracle and the torch backend on
    ``device``, then the resident stream and its continuation; returns the
    results, the parity verdicts, the residency counters and, under
    ``"headline"``, the printed numbers."""
    dev = resolve_device(device)
    say = log or (lambda *_: None)

    say("fitting IR component models (twin ground truth)...")
    twin, models = fit_app("IR", seed=0, n_inputs=120, configs=CONFIGS)
    tasks = BurstyWorkload(rate_per_s=4.0, size_sampler=twin.sample_input,
                           burst_multiplier=8.0, mean_quiet_s=10.0,
                           mean_burst_s=6.0, seed=31).generate(n_tasks)

    def runtime(on):
        pred = build_fleet_predictor(models, dict(FLEET), configs=CONFIGS)
        eng = DecisionEngine(predictor=pred,
                             policy=MinLatencyPolicy(c_max=C_MAX,
                                                     alpha=ALPHA),
                             device=on)
        backend = TwinBackend(twin, seed=11, edge_names=tuple(FLEET),
                              edge_speed=FLEET)
        return PlacementRuntime(eng, backend)

    def serve(backend, on):
        rt = runtime(on)
        t0 = time.perf_counter()
        res = rt.serve_stream(tasks, chunk_size=chunk, array_backend=backend)
        return res, time.perf_counter() - t0, rt.engine

    say(f"serving {n_tasks} bursty tasks, chunk={chunk}, 3-device fleet...")
    ref, t_np, _ = serve("numpy", "cpu")
    comp, t_dev, eng_dev = serve("torch", dev)

    bit_equal = (list(ref.records.targets) == list(comp.records.targets)
                 and all(np.array_equal(getattr(ref.records, c),
                                        getattr(comp.records, c))
                         for c in COLS))
    dec_equal = list(ref.records.targets) == list(comp.records.targets)
    close = all(np.allclose(getattr(ref.records, c).astype(float),
                            getattr(comp.records, c).astype(float),
                            rtol=1e-9)
                for c in COLS)
    if dev.type == "cpu":
        assert bit_equal, \
            "the torch backend on the CPU must be bit-identical to the oracle"
    assert dec_equal and close, "the torch backend must be decision-identical"

    say(f"\nnumpy oracle          : {t_np:.2f} s")
    say(f"torch ({dev.type:<4})          : {t_dev:.2f} s  decision-identical: "
        f"{dec_equal}  floats close: {close}  bit-identical: {bit_equal}")
    say(f"torch stats           : {eng_dev.torch_stats} (last chunk)")
    say(f"avg latency           : {ref.avg_actual_latency_ms:.1f} ms   "
        f"total cost: ${ref.total_actual_cost:.6f}")

    # --- persistent residency (3-chunk resident stream) ---------------------
    # Stream state stays on the device across chunks: no host commit at
    # chunk boundaries, one materialization at stream end. A same-shape
    # continuation stream on the same engine (arrivals keep moving forward —
    # replaying past arrivals would cold-start into ever-larger pools) must
    # regrow no pool, keep its placement core and build no kernel library.
    demo = BurstyWorkload(rate_per_s=4.0, size_sampler=twin.sample_input,
                          burst_multiplier=8.0, mean_quiet_s=10.0,
                          mean_burst_s=6.0, seed=32).generate(6 * chunk)
    rt_ref, rt_res = runtime("cpu"), runtime(dev)
    ref_r = rt_ref.serve_stream(demo[:3 * chunk], chunk_size=chunk)
    res_r = rt_res.serve_stream(demo[:3 * chunk], chunk_size=chunk,
                                array_backend="torch")
    r = rt_res.stream_stats["residency"]
    assert list(ref_r.records.targets) == list(res_r.records.targets), \
        "resident stream diverged from the numpy oracle"
    assert r["enabled"] and r["resident_chunks"] == 3
    assert r["chunk_commits"] == 0 and r["state_syncs"] == 1

    core_r, libs0 = torch_core.core_for(rt_res.engine), sorted(_build._LIBS)
    cont = rt_res.serve_stream(demo[3 * chunk:], chunk_size=chunk,
                               array_backend="torch")
    c = rt_res.stream_stats["residency"]
    no_rebuild = (c["pool_regrows"] == 0
                  and torch_core.core_for(rt_res.engine) is core_r
                  and sorted(_build._LIBS) == libs0)
    assert no_rebuild, "same-shape continuation stream rebuilt"
    say(f"resident stream       : 3/3 chunks device-resident, "
        f"{r['state_syncs']} host sync (stream end), "
        f"{r['chunk_commits']} chunk commits, prefetched {r['prefetched']}, "
        f"no-rebuild continuation: {no_rebuild}")
    return {"ref": ref, "comp": comp, "bit_equal": bit_equal,
            "dec_equal": dec_equal, "close": close, "numpy_s": t_np,
            "device_s": t_dev, "resident_ref": ref_r, "resident": res_r,
            "residency": r, "continuation": cont, "continuation_stats": c,
            "no_rebuild": no_rebuild,
            "headline": {"decision_identical": dec_equal,
                         "bit_identical": bit_equal, "numpy_s": t_np,
                         "device_s": t_dev, "residency": r,
                         "no_rebuild": no_rebuild}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    run(args.device, log=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
