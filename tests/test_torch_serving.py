"""The port's live serving path on the CPU: executors, pool, calibration and
the placement runtime, mirroring ``tests/test_serving_live.py`` on its
``TINY`` config with ``device="cpu"``.

On the CPU an executor's cold start draws the weights and runs one eager
warm-up prefill and decode (on the card it also captures the prefill and
the decode step in CUDA graphs); prefill and decode steps run eagerly. The
dense family runs on ``TINY``, the SSM and hybrid families on their smoke
configs. Imports torch, numpy and
``repro_torch`` only.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import smoke_config
from repro_torch.core.decision import MinLatencyPolicy
from repro_torch.modeling.registry import build_model
from repro_torch.serving.engine import (
    batch_prompts,
    generate,
    make_compiled_steps,
)
from repro_torch.serving.executors import (
    ExecutionRecord,
    LiveExecutor,
    NetworkProfile,
    SliceSpec,
    _Dispatch,
    make_pool,
)
from repro_torch.serving.placement import (
    LivePlacementServer,
    calibrate_catalog,
    llm_workload,
    make_live_runtime,
)

TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab=64, n_heads=2,
            n_kv_heads=2, head_dim=16)
CPU = "cpu"


@pytest.fixture(scope="module")
def tiny_cfg():
    return smoke_config("llama3.2-1b").with_updates(**TINY)


def test_generate_loop(tiny_cfg):
    model, params, _, _ = make_compiled_steps(tiny_cfg, seed=0, device=CPU)
    toks = torch.as_tensor(np.random.default_rng(0).integers(2, 64,
                                                             size=(2, 8)),
                           dtype=torch.int32)
    out = generate(model, params, toks, max_new_tokens=5, cache_len=16)
    assert out.shape == (2, 5)
    assert bool(((out >= 0) & (out < 64)).all())
    # temperature sampling draws from a seeded generator: reproducible
    a = generate(model, params, toks, max_new_tokens=5, cache_len=16,
                 temperature=1.0, seed=4)
    b = generate(model, params, toks, max_new_tokens=5, cache_len=16,
                 temperature=1.0, seed=4)
    assert torch.equal(a, b)


def test_compiled_steps_are_seeded(tiny_cfg):
    _, p1, _, _ = make_compiled_steps(tiny_cfg, seed=5, device=CPU)
    _, p2, _, _ = make_compiled_steps(tiny_cfg, seed=5, device=CPU)
    _, p3, _, _ = make_compiled_steps(tiny_cfg, seed=6, device=CPU)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert not torch.equal(p1["embed/w"], p3["embed/w"])
    assert set(p1) == set(build_model(tiny_cfg).param_specs())


def test_batch_prompts_left_pads():
    out = batch_prompts([np.array([1, 2, 3]), np.array([9])], pad_to=5)
    np.testing.assert_array_equal(out[0], [0, 0, 1, 2, 3])
    np.testing.assert_array_equal(out[1], [0, 0, 0, 0, 9])


def test_executor_cold_then_warm(tiny_cfg):
    ex = LiveExecutor(SliceSpec("s2", 2), tiny_cfg, device=CPU)
    r1 = ex.execute(32, 128.0)
    assert r1.cold and r1.start_ms > 0.05  # weights + warm-up take real time
    r2 = ex.execute(32, 128.0)
    assert not r2.cold and r2.start_ms < 5
    # eviction drops the weights: the next dispatch starts cold again
    ex.evict()
    assert not ex.is_warm()
    r3 = ex.execute(32, 128.0)
    assert r3.cold and r3.start_ms > 0.05


def test_executor_runs_the_kernel_wrappers_on_cpu(tiny_cfg):
    """On the CPU the wrappers take their plain versions: no launches."""
    kernels.reset_launch_counts()
    LiveExecutor(SliceSpec("s2", 2), tiny_cfg, device=CPU).execute(64, 1.0)
    assert set(kernels.launch_counts().values()) == {0}


def test_more_chips_fewer_steps(tiny_cfg):
    e1 = LiveExecutor(SliceSpec("s1", 1, tokens_per_step=8), tiny_cfg,
                      device=CPU)
    e4 = LiveExecutor(SliceSpec("s4", 4, tokens_per_step=8), tiny_cfg,
                      device=CPU)
    e1.execute(8, 1.0)
    e4.execute(8, 1.0)  # warm both
    # 2048 tokens: 256 vs 64 real decode steps; best-of-3 against noise
    n = 2048
    r1 = min(e1.execute(n, 1.0).comp_ms for _ in range(3))
    r4 = min(e4.execute(n, 1.0).comp_ms for _ in range(3))
    assert r4 < r1, (r1, r4)


def test_pool_virtual_time_warm_cold(tiny_cfg):
    pool = make_pool(tiny_cfg, [SliceSpec("s2", 2)], t_idl_ms=1000.0,
                     device=CPU)
    assert pool.probe_cold("s2", now=0.0)
    rec = pool.execute_cloud("s2", 16, 1.0, now=0.0)
    assert rec.cold
    done = rec.start_ms + rec.comp_ms
    assert not pool.probe_cold("s2", now=done + 10.0)
    # long after: provider reclaimed, and the next dispatch starts cold
    assert pool.probe_cold("s2", now=done + 10_000.0)
    rec2 = pool.execute_cloud("s2", 16, 1.0, now=done + 10_000.0)
    assert rec2.cold


def test_edge_fifo_queueing(tiny_cfg):
    pool = make_pool(tiny_cfg, [], device=CPU)
    r1 = pool.execute_edge(64, 1.0, arrival_ms=0.0)
    assert r1.queue_ms == 0.0
    r2 = pool.execute_edge(64, 1.0, arrival_ms=0.1)
    assert r2.queue_ms > 0.0


def test_pool_counts_resident_executors(tiny_cfg):
    pool = make_pool(tiny_cfg, [SliceSpec("s2", 2)], t_idl_ms=1_000.0,
                     device=CPU)
    assert pool.resident() == pool.peak_resident == 1  # the edge
    pool.execute_cloud("s2", 16, 1.0, now=0.0)
    assert pool.resident() == pool.peak_resident == 2
    pool._reap("s2", now=1e9)  # idle past its lifetime: evicted
    assert pool.resident() == 1 and pool.peak_resident == 2
    assert all(ex.device == torch.device("cpu")
               for ex in pool.edges.values())


def test_serving_bytes_and_resident_capacity():
    """The bytes an executor holds, from the specs and the serving cast
    (recurrentgemma-9b: 19.1 GB of bf16 and 3.5 GB of float32), and the
    pool's cap: none on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import serving_bytes
    from repro_torch.serving.executors import resident_capacity

    cfg = get_config("recurrentgemma-9b")
    f32 = 26 * (2 * 4096 * 4096 + 3 * 4096)  # gates, gate biases, lambda
    norms = 26 * 2 * 4096 + 12 * 2 * 4096 + 4096
    n = build_model(cfg).param_count()
    assert serving_bytes(cfg) == 2 * (n - f32 - norms) + 4 * (f32 + norms)
    assert 22.5e9 < serving_bytes(cfg) < 22.7e9
    assert resident_capacity(cfg, (torch.device("cpu"),)) is None
    # olmoe-1b-7b: its 16 routers (2,048 x 64) and norms stay float32
    cfg = get_config("olmoe-1b-7b")
    f32 = 16 * 2048 * 64 + (2 * 16 + 1) * 2048
    n = build_model(cfg).param_count()
    assert serving_bytes(cfg) == 2 * (n - f32) + 4 * f32


def test_pool_queues_at_its_resident_cap(tiny_cfg):
    """At ``max_resident`` a dispatch that finds its config's container busy
    queues behind it on the virtual clock (warm, the wait in its latency)
    instead of provisioning another model; below the cap, or uncapped, the
    pool provisions as the reference's does."""
    capped = make_pool(tiny_cfg, [SliceSpec("s2", 2)], t_idl_ms=1e9,
                       device=CPU)
    assert capped.max_resident is None  # no cap on the CPU
    capped.max_resident = 2  # as a card that holds two models
    r1 = capped.execute_cloud("s2", 16, 1.0, now=0.0)
    busy_until = r1.start_ms + r1.comp_ms
    assert not capped.probe_cold("s2", now=1.0)
    r2 = capped.execute_cloud("s2", 16, 1.0, now=1.0)
    assert not r2.cold and r2.queue_ms == pytest.approx(busy_until - 1.0)
    assert r2.total_ms >= r2.queue_ms
    assert capped.peak_resident == 2 and capped.reclaimed == 0
    assert capped.cap_waits == 1
    assert capped.cap_wait_ms == pytest.approx(busy_until - 1.0)
    assert len(capped.containers["s2"]) == 1
    free = make_pool(tiny_cfg, [SliceSpec("s2", 2)], t_idl_ms=1e9,
                     device=CPU)
    free.execute_cloud("s2", 16, 1.0, now=0.0)
    assert free.probe_cold("s2", now=1.0)
    r2 = free.execute_cloud("s2", 16, 1.0, now=1.0)
    assert r2.cold and r2.queue_ms == 0.0 and free.peak_resident == 3


def test_pool_reclaims_past_its_resident_cap(tiny_cfg):
    """With ``max_resident`` the pool never holds more models than the cap:
    a provision past it evicts the container that frees first, of any
    config (an idle one at once); without the cap it keeps them all."""
    specs = [SliceSpec("s2", 2), SliceSpec("s4", 4)]
    capped = make_pool(tiny_cfg, specs, t_idl_ms=1e9, device=CPU)
    capped.max_resident = 2
    free = make_pool(tiny_cfg, specs, t_idl_ms=1e9, device=CPU)
    for pool in (capped, free):
        pool.execute_cloud("s2", 16, 1.0, now=0.0)
        pool.execute_cloud("s4", 16, 1.0, now=1e6)
        pool.execute_cloud("s2", 16, 1.0, now=2e6)
    assert capped.peak_resident == 2 and capped.reclaimed == 2
    assert capped.cap_waits == 0  # the evicted containers were idle
    assert [c.is_warm() for c in capped.containers["s2"]] == [True]
    assert capped.containers["s4"] == []
    assert free.peak_resident == 3 and free.reclaimed == 0


def test_pool_at_its_cap_waits_for_an_executing_container(tiny_cfg):
    """At ``max_resident`` with every warm container executing, a dispatch
    of another config waits until one lands and then takes its place: the
    pool never provisions past the cap. The wait is the landed container's
    virtual completion less the arrival, counted in ``cap_waits``."""
    pool = make_pool(tiny_cfg, [SliceSpec("s2", 2), SliceSpec("s4", 4)],
                     t_idl_ms=1e9, edge_specs=[], device=CPU)
    pool.max_resident = 1
    c = pool.lease("s2", 0.0)
    c._compiled = ("stub",)  # resident and executing
    got = []
    t = threading.Thread(target=lambda: got.append(pool.lease("s4", 10.0)))
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive() and pool.containers["s4"] == []
    _landed(pool, c, arrival_ms=0.0, busy_ms=100.0)
    t.join(timeout=10.0)
    assert not t.is_alive() and len(got) == 1
    assert got[0].queued_ms == pytest.approx(90.0) and got[0].in_flight
    assert pool.containers == {"s2": [], "s4": got}
    assert not c.is_warm() and pool.reclaimed == 1
    assert pool.cap_waits == 1 and pool.cap_wait_ms == pytest.approx(90.0)
    assert pool.peak_resident == 1


def test_pool_refuses_a_cap_its_edge_fleet_fills(tiny_cfg):
    """A card that holds no more serving copies than the edge fleet takes
    has no room for a cloud container: the dispatch raises instead of
    provisioning past the cap."""
    pool = make_pool(tiny_cfg, [SliceSpec("s2", 2)], t_idl_ms=1e9,
                     device=CPU)
    pool.max_resident = 1
    with pytest.raises(RuntimeError, match="no cloud container fits"):
        pool.execute_cloud("s2", 16, 1.0, now=0.0)
    assert pool.containers["s2"] == [] and pool.resident() == 1


# ------------------------------------------- out-of-order completion landing
def _landed(pool, c, arrival_ms, busy_ms, warm=True):
    """Land a synthetic completion on a leased container at an exact virtual
    time (a stand-in for a real execution finishing)."""
    if warm:
        c._compiled = ("stub",)  # resident model, no real set-up
    pool.land(c, arrival_ms, ExecutionRecord(
        feed_ms=0.0, start_ms=0.0, comp_ms=busy_ms, store_ms=0.0, cold=False))


def test_pool_reap_protects_in_flight_containers(tiny_cfg):
    pool = make_pool(tiny_cfg, [SliceSpec("s2", 2)], t_idl_ms=1_000.0,
                     edge_specs=[], device=CPU)
    c = pool.lease("s2", 0.0)
    assert c.in_flight and c.last_completion == 0.0
    pool._reap("s2", now=50_000.0)
    assert c in pool.containers["s2"]
    _landed(pool, c, arrival_ms=50_000.0, busy_ms=100.0)
    assert not c.in_flight
    assert not pool.probe_cold("s2", now=50_150.0)
    assert pool.lease("s2", 50_150.0) is c


def test_pool_eviction_sweeps_completion_order_not_push_order(tiny_cfg):
    pool = make_pool(tiny_cfg, [SliceSpec("s2", 2)], t_idl_ms=1_000.0,
                     edge_specs=[], device=CPU)
    a = pool.lease("s2", 0.0)
    b = pool.lease("s2", 0.0)
    _landed(pool, b, arrival_ms=0.0, busy_ms=5_000.0)  # completes 5000
    _landed(pool, a, arrival_ms=0.0, busy_ms=500.0)    # completes  500
    pool._reap("s2", now=1_600.0)
    assert pool.containers["s2"] == [b]
    assert not a.is_warm(), "expired container must drop its model"
    pool._reap("s2", now=6_200.0)
    assert pool.containers["s2"] == []


def test_pool_failed_execution_releases_the_lease(tiny_cfg, monkeypatch):
    pool = make_pool(tiny_cfg, [SliceSpec("s2", 2)], t_idl_ms=60_000.0,
                     edge_specs=[], device=CPU)
    boom = RuntimeError("transient executor failure")
    monkeypatch.setattr(LiveExecutor, "execute",
                        lambda self, n, b: (_ for _ in ()).throw(boom))
    with pytest.raises(RuntimeError, match="transient"):
        pool.execute_cloud("s2", 16, 1.0, now=0.0)
    (c,) = pool.containers["s2"]
    assert not c.in_flight, "failed execution must release the lease"
    monkeypatch.undo()
    _landed(pool, c, arrival_ms=10.0, busy_ms=100.0)
    assert pool.lease("s2", 500.0) is c


def test_pool_mru_reuse_follows_landed_completions(tiny_cfg):
    pool = make_pool(tiny_cfg, [SliceSpec("s2", 2)], t_idl_ms=60_000.0,
                     edge_specs=[], device=CPU)
    a = pool.lease("s2", 0.0)
    b = pool.lease("s2", 0.0)
    _landed(pool, b, arrival_ms=0.0, busy_ms=100.0)   # completes 100
    _landed(pool, a, arrival_ms=0.0, busy_ms=900.0)   # completes 900
    assert pool.lease("s2", 2_000.0) is a


# ---------------------------------------------------- concurrent dispatch
def test_serve_concurrent_matches_targets_and_queues(tiny_cfg):
    pool = make_pool(tiny_cfg, [SliceSpec("s2", 2, tokens_per_step=4)],
                     edge_specs=[SliceSpec(f"edge{i}", 1, tokens_per_step=4,
                                           is_edge=True) for i in range(2)],
                     device=CPU)
    plan = [
        _Dispatch(0, "edge0", 64, 16.0, 0.0),
        _Dispatch(1, "edge1", 64, 16.0, 0.0),
        _Dispatch(2, "s2", 32, 16.0, 0.0),
        _Dispatch(3, "edge0", 64, 16.0, 0.1),  # queues behind dispatch 0
    ]
    recs = pool.serve_concurrent(plan)
    assert all(r is not None for r in recs)
    assert recs[3].queue_ms > 0.0
    assert recs[2].cold
    assert pool.edge_free_at["edge0"] == pytest.approx(
        recs[0].comp_ms + recs[3].comp_ms)
    assert pool.edge_free_at["edge1"] == pytest.approx(recs[1].comp_ms)
    assert recs[3].queue_ms == pytest.approx(recs[0].comp_ms - 0.1)


def test_serve_concurrent_cancels_unstarted_race_loser(tiny_cfg):
    pool = make_pool(tiny_cfg, [SliceSpec("s2", 2, tokens_per_step=4)],
                     edge_specs=[SliceSpec("edge", 1, tokens_per_step=4,
                                           is_edge=True)], device=CPU)
    plan = [
        _Dispatch(0, "s2", 6_000, 16.0, 0.0),   # long head-of-line blocker
        _Dispatch(1, "edge", 8, 16.0, 1.0),     # primary: tiny, finishes fast
        _Dispatch(2, "s2", 6_000, 16.0, 1.0),   # hedge: queued behind 0
    ]
    recs = pool.serve_concurrent(plan, races=[(1, 2)])
    assert recs[0] is not None and recs[1] is not None
    assert recs[2] is None, "queued race loser must be cancelled"


# ------------------------------------------------- calibrate, then serve
@pytest.fixture(scope="module")
def tiny_catalog(tiny_cfg):
    specs = [SliceSpec("s2", 2, tokens_per_step=4),
             SliceSpec("s8", 8, tokens_per_step=4)]
    return calibrate_catalog(tiny_cfg, specs, n_tasks=6, n_cold=1, seed=0,
                             device=CPU)


def test_live_async_serve_overlaps_and_serves_all(tiny_catalog):
    tasks = llm_workload(24, rate_per_s=40.0, seed=2, mean_tokens=128)
    rt = make_live_runtime(tiny_catalog,
                           MinLatencyPolicy(c_max=0.01, alpha=0.05),
                           t_idl_ms=30_000.0, n_edge_devices=3,
                           network=NetworkProfile(base_ms=2.0), device=CPU)
    res = rt.serve_async(tasks)
    assert res.n == 24
    assert np.isfinite(res.avg_actual_latency_ms)
    assert res.total_actual_cost <= 0.01 * 24
    assert sum(s.n_tasks for s in res.device_summaries().values()) == res.n_edge


def test_live_placement_server_end_to_end(tiny_catalog):
    """Calibrate, then serve: placement + real execution + metrics."""
    assert tiny_catalog.start_cold.mean > 0.0
    assert tiny_catalog.start_cold.mean > tiny_catalog.start_warm.mean
    tasks = llm_workload(25, rate_per_s=40.0, seed=1, mean_tokens=128)
    srv = LivePlacementServer(tiny_catalog,
                              MinLatencyPolicy(c_max=0.01, alpha=0.05),
                              t_idl_ms=30_000.0, device=CPU)
    res = srv.serve(tasks)
    assert res.n == 25 and res.n_failed == 0
    assert res.total_actual_cost <= 0.01 * 25
    assert np.isfinite(res.avg_actual_latency_ms)
    # an order-of-magnitude ballpark: CPU timings of sub-millisecond steps
    # are machine-state noise
    ratio = res.avg_predicted_latency_ms / res.avg_actual_latency_ms
    assert 0.05 < ratio < 20.0, res.latency_error_pct
    assert srv.engine.device == torch.device("cpu")
    assert srv.pool.peak_resident >= 1


# ----------------------------------------------- the SSM family (Mamba-2)
def test_mamba_live_calibrate_then_serve():
    """Calibrate, then serve the smoke Mamba-2 LM live on the CPU: the
    executors build it through the registry, prefill through the SSD scan's
    plain version (no launches) and decode its O(1) state eagerly."""
    cfg = smoke_config("mamba2-780m")
    specs = [SliceSpec("s2", 2, tokens_per_step=4),
             SliceSpec("s8", 8, tokens_per_step=4)]
    cat = calibrate_catalog(cfg, specs, n_tasks=6, n_cold=1, seed=0,
                            device=CPU)
    assert cat.start_cold.mean > cat.start_warm.mean
    kernels.reset_launch_counts()
    rt = make_live_runtime(cat, MinLatencyPolicy(c_max=0.01, alpha=0.05),
                           t_idl_ms=30_000.0, device=CPU)
    res = rt.serve(llm_workload(20, rate_per_s=40.0, seed=1,
                                mean_tokens=128))
    assert res.n == 20 and res.n_failed == 0 and res.n_shed == 0
    assert np.isfinite(res.avg_actual_latency_ms)
    assert res.total_actual_cost <= 0.01 * 20
    assert set(kernels.launch_counts().values()) == {0}
    assert rt.backend.pool.peak_resident >= 1


# ------------------------------------------ the hybrid family (Griffin)
HYBRID = "recurrentgemma-9b"


def test_griffin_executor_and_pool_on_cpu():
    """A live executor and a pool of the smoke Griffin LM on the CPU: cold
    then warm, the RG-LRU through K3's plain version and the local
    attention through K4's and K5's (no launches), an eviction and the
    resident count."""
    cfg = smoke_config(HYBRID)
    kernels.reset_launch_counts()
    ex = LiveExecutor(SliceSpec("s2", 2, tokens_per_step=4), cfg, device=CPU)
    r1 = ex.execute(64, 16.0)  # 8 decode steps: the 16-slot ring wraps
    r2 = ex.execute(64, 16.0)
    assert r1.cold and not r2.cold and r2.start_ms < r1.start_ms
    assert set(kernels.launch_counts().values()) == {0}
    ex.evict()
    assert not ex.is_warm()
    pool = make_pool(cfg, [SliceSpec("s2", 2)], t_idl_ms=1_000.0, device=CPU)
    assert pool.resident() == pool.peak_resident == 1  # the edge
    rec = pool.execute_cloud("s2", 16, 1.0, now=0.0)
    assert rec.cold and pool.resident() == 2
    assert not pool.probe_cold("s2", now=rec.start_ms + rec.comp_ms + 1.0)


def test_griffin_live_calibrate_then_serve(monkeypatch):
    """Calibrate, then serve the smoke Griffin LM live on the CPU. The
    calibration releases every executor it measured with before it returns
    (the serving pool builds its own)."""
    cfg = smoke_config(HYBRID)
    specs = [SliceSpec("s4", 4, tokens_per_step=4),
             SliceSpec("s8", 8, tokens_per_step=4)]
    evicted = []
    evict = LiveExecutor.evict
    monkeypatch.setattr(LiveExecutor, "evict", lambda self: (
        evicted.append(self), evict(self))[1])
    cat = calibrate_catalog(cfg, specs, n_tasks=6, n_cold=1, seed=0,
                            device=CPU)
    # the warm-up, one cold start per slice, one warm executor per slice
    # and the edge executor
    assert len(evicted) == 1 + 2 + 2 + 1
    assert not any(ex.is_warm() for ex in evicted)
    assert cat.start_cold.mean > cat.start_warm.mean
    kernels.reset_launch_counts()
    rt = make_live_runtime(cat, MinLatencyPolicy(c_max=0.01, alpha=0.05),
                           t_idl_ms=30_000.0, device=CPU)
    res = rt.serve(llm_workload(20, rate_per_s=40.0, seed=1,
                                mean_tokens=128))
    assert res.n == 20 and res.n_failed == 0 and res.n_shed == 0
    assert np.isfinite(res.avg_actual_latency_ms)
    assert set(kernels.launch_counts().values()) == {0}
    assert rt.backend.pool.peak_resident >= 1


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m", HYBRID,
                                  "olmoe-1b-7b"])
def test_serve_cli_on_cpu(arch, capsys):
    """The port's serve CLI with ``--device cpu`` serves the smoke
    reduction of every ported family."""
    from repro_torch.launch import serve as serve_cli

    rc = serve_cli.main(["--arch", arch, "--device", "cpu", "--n", "6",
                         "--rate", "40", "--chips", "2", "--calib-tasks", "2",
                         "--mean-tokens", "32", "--t-idl-s", "20"])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"on {arch}" in out and "served n=6" in out


def _kernel_launch_error():
    from repro_torch.kernels._build import KernelLaunchError

    return KernelLaunchError(
        "flash_attention: CUDA launch failed with error code 700")


@pytest.mark.parametrize("error,mapped", [
    (torch.AcceleratorError("CUDA error: an illegal memory access was "
                            "encountered"), False),
    (_kernel_launch_error(), False),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     True),
    (RuntimeError("expected all tensors to be on cuda:0"), True),
    (RuntimeError("executor lease expired"), True),
    (ValueError("bad payload"), True),
    (TimeoutError("slice did not answer"), True),
], ids=["accelerator", "refused_launch", "cuda_oom", "names_cuda", "runtime",
        "value", "timeout"])
def test_live_backend_never_maps_a_cuda_error(monkeypatch, error, mapped):
    """With ``map_failures`` on (any retry or breaker policy), a dispatch
    that raises comes back as a TRANSIENT failure, as in the reference —
    except a sticky CUDA error or a kernel that could not be built or
    launched, which is re-raised so a failed kernel is not hidden behind a
    stream of retries. An out-of-memory error stays mapped: the allocator
    recovers from it. The message's text decides nothing."""
    from repro_torch.core.faults import TRANSIENT
    from repro_torch.core.workload import TaskInput
    from repro_torch.serving.placement import LiveBackend, is_cuda_error

    backend = LiveBackend(pool=None, pricing=None, map_failures=True,
                          detect_ms=5.0)

    def raising(task, target, now):
        raise error

    monkeypatch.setattr(backend, "_execute_raw", raising)
    task = TaskInput(idx=0, arrival_ms=10.0, size=8.0, bytes=64.0)
    assert is_cuda_error(error) is not mapped
    if mapped:
        out = backend.execute(task, "s2", 10.0)
        assert out.failed and out.fail_kind == TRANSIENT
        assert out.completion_ms == 15.0 and out.cost == 0.0
    else:
        with pytest.raises(type(error)):
            backend.execute(task, "s2", 10.0)
    backend.map_failures = False
    with pytest.raises(type(error)):
        backend.execute(task, "s2", 10.0)
