"""The port's torch placement core against the JAX package's numpy oracle.

``PlacementRuntime.serve_stream(array_backend="torch", device="cpu")`` of
``repro_torch`` must be BIT-IDENTICAL per record — every float column, every
target — to ``repro``'s numpy ``serve_stream`` on the same stream, with the
models fitted by ``repro`` and carried across as numpy arrays
(``repro_torch.core.convert``). The matrix mirrors ``tests/test_jax_core.py``:
MinCost / MinLatency x 1- and 3-device fleets x chunk sizes {1, 53, 4096}
with the least-predicted-wait balancer, plus round-robin and random
balancers; then a hedged-policy fallback chunk mid-stream, a forced pool
grow-and-retry, the residency counters, and the backend plumbing. Every
chunk's ``state_walk`` decisions must be reproduced by the one verifying
replay pass (``place_chunk`` raises otherwise; a test checks that it does).
Tolerance: none — exact equality (``np.array_equal``) throughout.
"""

from __future__ import annotations

import numpy as np
import pytest
from torch.overrides import TorchFunctionMode

import repro.core.decision as ref_decision
import repro_torch.core.decision as decision_mod
from repro.core.decision import DecisionEngine as RefEngine
from repro.core.decision import HedgedPolicy as RefHedged
from repro.core.decision import MinCostPolicy as RefMinCost
from repro.core.decision import MinLatencyPolicy as RefMinLat
from repro.core.decision import RandomBalancer as RefRandom
from repro.core.decision import RoundRobinBalancer as RefRoundRobin
from repro.core.fit import build_fleet_predictor as ref_build_fleet
from repro.core.fit import fit_app as ref_fit_app
from repro.core.runtime import PlacementRuntime as RefRuntime
from repro.core.runtime import TwinBackend as RefTwinBackend
from repro.core.workload import BurstyWorkload as RefBursty
from repro_torch import kernels
from repro_torch.core import torch_core
from repro_torch.core.apps import APPS, AWSTwin
from repro_torch.core.convert import (
    fitted_models_from_arrays,
    fitted_models_to_arrays,
)
from repro_torch.core.decision import (
    DecisionEngine,
    HedgedPolicy,
    MinCostPolicy,
    MinLatencyPolicy,
    RandomBalancer,
    RoundRobinBalancer,
)
from repro_torch.core.fit import build_fleet_predictor
from repro_torch.core.runtime import PlacementRuntime, TwinBackend
from repro_torch.core.workload import BurstyWorkload

CONFIGS = (1280, 1536, 1792)
FLEET3 = {"edge0": 1.0, "edge1": 1.0, "edge2": 0.6}
FLEET1 = {"edge0": 1.0}

RECORD_COLS = ("predicted_latency_ms", "predicted_cost", "actual_latency_ms",
               "actual_cost", "allowed_cost", "completion_ms", "queue_wait_ms",
               "exec_ms", "hedge_exec_ms", "predicted_cold", "actual_cold",
               "feasible", "hedged", "arrival_ms")


def export_models(m) -> dict:
    """The reference's fitted models as plain numpy arrays, read attribute
    by attribute (the keys ``repro_torch.core.convert`` documents)."""
    out = {f"{k}.theta": np.array(getattr(m, k).theta)
           for k in ("upld", "comp_edge")}
    for k in ("start_warm", "start_cold", "store_cloud", "iotup",
              "store_edge"):
        nm = getattr(m, k)
        out.update({f"{k}.mean": nm.mean, f"{k}.std": nm.std,
                    f"{k}.quantum": nm.quantum})
    g = m.comp_cloud
    c = g.config
    out.update({"comp_cloud.features": np.array(g.features),
                "comp_cloud.thresholds": np.array(g.thresholds),
                "comp_cloud.leaves": np.array(g.leaves),
                "comp_cloud.base": g.base,
                "comp_cloud.config": np.array(
                    [c.n_trees, c.max_depth, c.learning_rate, c.n_bins,
                     c.min_samples_leaf, c.min_gain])})
    for k in ("cloud_comp_std_frac", "edge_comp_std_frac", "cloud_e2e_mape",
              "edge_e2e_mape"):
        out[k] = getattr(m, k)
    return out


@pytest.fixture(scope="module")
def setup():
    ref_twin, ref_models = ref_fit_app("IR", seed=0, n_inputs=120,
                                       configs=CONFIGS)
    models = fitted_models_from_arrays(export_models(ref_models))
    return ref_twin, ref_models, AWSTwin(spec=APPS["IR"], seed=0), models


def _policies():
    return [("min_latency", lambda ref: (RefMinLat if ref else MinLatencyPolicy)(
                c_max=6e-6, alpha=0.05)),
            ("min_cost", lambda ref: (RefMinCost if ref else MinCostPolicy)(
                deadline_ms=250.0))]


def _runtimes(setup, fleet=FLEET3, policy_fn=None, balancer_fn=None, seed=11):
    """(reference numpy runtime, port runtime on the CPU) over the same
    models, fleet, policy and twin seed."""
    ref_twin, ref_models, twin, models = setup
    policy_fn = policy_fn or _policies()[0][1]
    out = []
    for ref in (True, False):
        build = ref_build_fleet if ref else build_fleet_predictor
        pred = build(ref_models if ref else models, dict(fleet),
                     configs=CONFIGS)
        kw = {} if ref else {"device": "cpu"}
        eng = (RefEngine if ref else DecisionEngine)(
            predictor=pred, policy=policy_fn(ref),
            balancer=balancer_fn(ref) if balancer_fn else None, **kw)
        backend = (RefTwinBackend if ref else TwinBackend)(
            ref_twin if ref else twin, seed=seed, edge_names=tuple(fleet),
            edge_speed=fleet)
        out.append((RefRuntime if ref else PlacementRuntime)(eng, backend))
    return out


def _bursty(setup, n, seed=31):
    """The same bursty stream in each package's task type."""
    ref_twin, _, twin, _ = setup
    kw = dict(rate_per_s=4.0, burst_multiplier=8.0, mean_quiet_s=10.0,
              mean_burst_s=6.0, seed=seed)
    ref = RefBursty(size_sampler=ref_twin.sample_input, **kw).generate(n)
    port = BurstyWorkload(size_sampler=twin.sample_input, **kw).generate(n)
    assert [(t.arrival_ms, t.size, t.bytes) for t in ref] == \
        [(t.arrival_ms, t.size, t.bytes) for t in port]
    return ref, port


def assert_records_equal(a, b):
    assert len(a) == len(b)
    assert list(a.targets) == list(b.targets)
    for col in RECORD_COLS:
        assert np.array_equal(np.asarray(getattr(a, col)),
                              np.asarray(getattr(b, col))), col


def test_models_carry_across_bit_for_bit(setup):
    _, ref_models, _, models = setup
    arrays = export_models(ref_models)
    back = fitted_models_to_arrays(models)
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        assert np.array_equal(np.asarray(back[k]), np.asarray(v)), k
    x = np.stack([np.linspace(5e4, 4e5, 97), np.full(97, 1536.0)], 1)
    assert np.array_equal(models.comp_cloud.predict(x),
                          ref_models.comp_cloud.predict(x))


# ---------------------------------------------------- per-record bit parity
@pytest.mark.parametrize("policy_name,policy_fn", _policies(),
                         ids=["min_latency", "min_cost"])
@pytest.mark.parametrize("fleet", [FLEET1, FLEET3], ids=["1dev", "3dev"])
@pytest.mark.parametrize("chunk_size,n", [(1, 60), (53, 300), (4096, 300)],
                         ids=["chunk1", "chunk53", "chunk4096"])
def test_torch_serve_bit_parity(setup, monkeypatch, policy_name, policy_fn,
                                fleet, chunk_size, n):
    """The headline guarantee, with the oracle's own speculation windows
    forced small so its repairs happen."""
    monkeypatch.setattr(ref_decision, "COLUMNAR_CHUNK", 64)
    ref_rt, rt = _runtimes(setup, fleet, policy_fn)
    ref_tasks, tasks = _bursty(setup, n)
    ref = ref_rt.serve_stream(ref_tasks, chunk_size=chunk_size)
    res = rt.serve_stream(tasks, chunk_size=chunk_size, array_backend="torch")
    assert_records_equal(res.records, ref.records)
    stats = rt.engine.torch_stats
    assert stats is not None and stats["device"] == "cpu"
    r = rt.stream_stats["residency"]
    assert r["fallback_chunks"] == 0 and r["chunk_commits"] == 0
    assert r["resident_chunks"] == rt.stream_stats["chunks"]
    assert r["state_syncs"] == 1 and r["fallback_syncs"] == 0


@pytest.mark.parametrize("policy_name,policy_fn", _policies(),
                         ids=["min_latency", "min_cost"])
@pytest.mark.parametrize("balancer", ["roundrobin", "random"])
def test_torch_parity_with_balancers(setup, policy_name, policy_fn, balancer):
    """Balancer nomination state is consumed exactly once per chunk, in
    arrival order — parity per record AND the cursor / rng advance."""
    if balancer == "roundrobin":
        bal = lambda ref: RefRoundRobin() if ref else RoundRobinBalancer()  # noqa: E731
    else:
        bal = lambda ref: RefRandom(seed=5) if ref else RandomBalancer(seed=5)  # noqa: E731
    ref_rt, rt = _runtimes(setup, FLEET3, policy_fn, bal)
    ref_tasks, tasks = _bursty(setup, 240)
    ref = ref_rt.serve_stream(ref_tasks, chunk_size=96)
    res = rt.serve_stream(tasks, chunk_size=96, array_backend="torch")
    assert_records_equal(res.records, ref.records)
    a, b = ref_rt.engine.balancer, rt.engine.balancer
    if balancer == "roundrobin":
        assert a._i == b._i
    else:
        assert a.rng.integers(1 << 30) == b.rng.integers(1 << 30)


# ------------------------------------------------------ fallback and retry
def test_hedged_chunk_falls_back_and_reenters_residency(setup):
    """A hedged chunk mid-stream exits residency through ONE fallback sync
    (the host walk sees canonical state), is counted as a fallback chunk,
    and the following chunks re-enter residency with state intact."""
    ref_rt, rt = _runtimes(setup)
    ref_tasks, tasks = _bursty(setup, 300)

    def swapping(runtime, ts, hedged):
        orig = runtime.engine.policy
        for i in range(5):
            if i == 2:
                runtime.engine.policy = hedged
            elif i == 3:
                runtime.engine.policy = orig
            yield ts[i * 60:(i + 1) * 60]

    ref = ref_rt.serve_stream(swapping(ref_rt, ref_tasks, RefHedged(
        RefMinLat(c_max=6e-6, alpha=0.05), hedge_threshold_ms=50.0)),
        chunk_size=60)
    # prefetch off: the transfer thread would pull chunk k+1 (firing the
    # swap side effect) while chunk k still places
    res = rt.serve_stream(swapping(rt, tasks, HedgedPolicy(
        MinLatencyPolicy(c_max=6e-6, alpha=0.05), hedge_threshold_ms=50.0)),
        chunk_size=60, array_backend="torch", prefetch=False)
    assert_records_equal(res.records, ref.records)
    assert rt.stream_stats["residency"]["fallback_chunks"] == 1
    core = torch_core.core_for(rt.engine)
    assert core.resident_chunks == 4
    assert core.fallback_syncs == 1 and core.state_syncs == 2
    assert core.chunk_commits == 0


def test_pool_grow_and_retry(setup, monkeypatch):
    """A chunk whose cold starts overflow the container pool walks again
    against a compacted (resident) or grown pool — nothing half-committed,
    parity intact. Chunks of 16 make both happen: the first chunk grows
    the one-slot pool, later resident chunks compact it on the device."""
    monkeypatch.setattr(torch_core, "POOL_MIN_CAP", 1)
    compactions = []
    compact = torch_core.TorchPlacementCore._compact

    def counted(self, *args):
        compactions.append(args[-1])
        return compact(self, *args)

    monkeypatch.setattr(torch_core.TorchPlacementCore, "_compact", counted)
    ref_rt, rt = _runtimes(setup)
    ref_tasks, tasks = _bursty(setup, 400)
    ref = ref_rt.serve_stream(ref_tasks, chunk_size=16)
    res = rt.serve_stream(tasks, chunk_size=16, array_backend="torch")
    assert_records_equal(res.records, ref.records)
    core = torch_core.core_for(rt.engine)
    assert core.pool_regrows >= 2 and len(compactions) >= 1
    assert 1 < rt.engine.torch_stats["pool_cap"] <= core.cap_limit
    assert rt.stream_stats["residency"]["state_syncs"] == 1


def test_regrowing_stream_keeps_parity_with_one_verdict_copy_per_walk(
        setup, monkeypatch):
    """A stream whose pools overflow (one-slot seeds, chunks of 64) stays
    bit-identical to the numpy oracle; every walk, the ones discarded for
    an overflow included, brings its verdict to the host in one copy; and
    a walk that overflowed hands its flags to the replay, which then does
    no work: each chunk replays once."""
    from repro_torch.kernels.state_replay import kernel as replay_kernel

    monkeypatch.setattr(torch_core, "POOL_MIN_CAP", 1)
    skips, runs = [], []
    replay, plain = torch_core.state_replay, replay_kernel.state_replay_plain

    def watched(*args, **kwargs):
        skips.append(bool(kwargs["skip"].any()))
        return replay(*args, **kwargs)

    def ran(*args, **kwargs):
        runs.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(torch_core, "state_replay", watched)
    monkeypatch.setattr(replay_kernel, "state_replay_plain", ran)
    ref_rt, rt = _runtimes(setup)
    ref_tasks, tasks = _bursty(setup, 600, seed=5)
    ref = ref_rt.serve_stream(ref_tasks, chunk_size=64)
    res = rt.serve_stream(tasks, chunk_size=64, array_backend="torch")
    assert_records_equal(res.records, ref.records)
    core = torch_core.core_for(rt.engine)
    assert core.pool_regrows >= 1
    chunks = -(-len(tasks) // 64)
    assert core.verify_syncs == chunks + core.pool_regrows
    assert len(skips) == chunks + core.pool_regrows
    assert sum(skips) == core.pool_regrows and len(runs) == chunks


# tensor methods that bring a value to the host (a sync on a card)
HOST_READS = ("__bool__", "item", "tolist", "cpu", "numpy", "__int__",
              "__float__", "__index__")


class _HostReads(TorchFunctionMode):
    """Records the host reads of tensors made outside the kernel wrappers
    (whose plain versions read their CPU tensors freely)."""

    def __init__(self):
        super().__init__()
        self.reads: list[str] = []
        self.in_kernel = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in HOST_READS and not self.in_kernel:
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


def test_chunk_verification_makes_one_host_sync(setup, monkeypatch):
    """``_walk_and_verify`` reads the device once per chunk: the walk's
    overflow flag, the verdict and the pools' largest count come to the
    host in one copy, outside the kernels."""
    mode = _HostReads()
    for name in ("state_walk", "state_replay", "prefix_sum"):
        fn = getattr(torch_core, name)

        def outside(*args, _fn=fn, **kwargs):
            mode.in_kernel += 1
            try:
                return _fn(*args, **kwargs)
            finally:
                mode.in_kernel -= 1

        monkeypatch.setattr(torch_core, name, outside)
    verify = torch_core.TorchPlacementCore._walk_and_verify
    per_call = []

    def watched(self, *args):
        mode.reads = []
        with mode:
            out = verify(self, *args)
        per_call.append(list(mode.reads))
        return out

    monkeypatch.setattr(torch_core.TorchPlacementCore, "_walk_and_verify",
                        watched)
    ref_rt, rt = _runtimes(setup)
    ref_tasks, tasks = _bursty(setup, 300)
    ref = ref_rt.serve_stream(ref_tasks, chunk_size=100)
    res = rt.serve_stream(tasks, chunk_size=100, array_backend="torch")
    assert_records_equal(res.records, ref.records)
    assert len(per_call) >= 3
    assert all(reads == ["tolist"] for reads in per_call), per_call


def test_walk_mismatch_raises(setup, monkeypatch):
    """The verifying replay holds the walk to the sequential trajectory: a
    walk whose codes the replay does not reproduce stops the chunk."""
    walk = torch_core.state_walk

    def wrong_walk(*args, **kwargs):
        code, overflow = walk(*args, **kwargs)
        code = code.clone()
        code[0] = -1    # a live row left undecided
        return code, overflow

    monkeypatch.setattr(torch_core, "state_walk", wrong_walk)
    _, rt = _runtimes(setup)
    _, tasks = _bursty(setup, 40)
    with pytest.raises(RuntimeError, match="does not reproduce"):
        rt.serve_stream(tasks, chunk_size=40, array_backend="torch")


def test_out_of_order_stream_falls_back(setup):
    ref_rt, rt = _runtimes(setup)
    ref_tasks, tasks = _bursty(setup, 120)
    for ts in (ref_tasks, tasks):
        ts[10], ts[50] = ts[50], ts[10]
    ref = ref_rt.serve_stream(ref_tasks, chunk_size=1000)
    res = rt.serve_stream(tasks, chunk_size=1000, array_backend="torch")
    assert_records_equal(res.records, ref.records)
    assert getattr(rt.engine, "torch_stats", None) is None
    assert rt.stream_stats["residency"]["fallback_chunks"] == 1


def test_external_place_many_between_streams(setup):
    """An out-of-stream ``serve`` between two resident streams sees the
    canonical host state (stream 1's end sync landed it) and commits per
    chunk."""
    ref_rt, rt = _runtimes(setup)
    ref_tasks, tasks = _bursty(setup, 200)
    refs = [ref_rt.serve_stream(ref_tasks[:80], chunk_size=40),
            ref_rt.serve(ref_tasks[80:120]),
            ref_rt.serve_stream(ref_tasks[120:], chunk_size=40)]
    got = [rt.serve_stream(tasks[:80], chunk_size=40, array_backend="torch")]
    rt.engine.array_backend = "torch"
    got.append(rt.serve(tasks[80:120]))
    rt.engine.array_backend = "numpy"
    got.append(rt.serve_stream(tasks[120:], chunk_size=40,
                               array_backend="torch"))
    for a, b in zip(got, refs):
        assert_records_equal(a.records, b.records)
    assert torch_core.core_for(rt.engine).chunk_commits >= 1


# --------------------------------------------------------- backend plumbing
def test_backend_and_device_plumbing(setup):
    _, rt = _runtimes(setup)
    _, tasks = _bursty(setup, 40)
    _, _, _, models = setup
    pred = build_fleet_predictor(models, dict(FLEET3), configs=CONFIGS)
    with pytest.raises(ValueError, match="array_backend"):
        DecisionEngine(predictor=pred, policy=MinLatencyPolicy(c_max=6e-6),
                       array_backend="jax", device="cpu")
    with pytest.raises(ValueError, match="array_backend"):
        rt.serve_stream(tasks, array_backend="cupy")
    assert rt.engine.array_backend == "numpy"
    kernels.reset_launch_counts()
    rt.serve_stream(tasks, chunk_size=40, array_backend="torch", device="cpu")
    assert rt.engine.array_backend == "numpy"
    assert str(rt.engine.device) == "cpu"
    assert rt.engine.predictor.device == rt.engine.device
    # CPU tensors run the plain versions: no kernel was launched
    assert set(kernels.launch_counts().values()) == {0}
    assert decision_mod.ARRAY_BACKENDS == ("numpy", "torch")
