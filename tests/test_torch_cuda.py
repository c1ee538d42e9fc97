"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: the fixture skips every test here when no CUDA card is
available (the CUDA kernels have no CPU mode). Imports torch, numpy and
``repro_torch`` only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Float64 results must be bit-equal to the plain versions (the same rounded
operations in the same order), as must the linear scan's exact fold and,
in float32 too, the GBRT kernels (the same per-tree roundings;
``test_kernels_on_card`` keeps its older float32 GBRT check, 1e-4); the
linear scan's chunked float32 regime and float32 attention within 5e-5,
bf16 attention within 3e-2 (the reference's own kernel tolerances); the
SSD scan's y within 1e-4 in float32 and within 3e-2 of max(1, |y|) in
bf16, its float32 state within 1e-4; the backward kernels K3b and K6b
within 5e-5 and 1e-4 of max(1, |grad|) in float32, K6b's bf16 rows
within 2^-6 of their largest |grad| (``chip_smoke.py``'s limits), each
bit-equal run to run. The kernels' CPU-side parity with
the JAX package is in ``tests/test_torch_modeling.py`` and
``tests/test_torch_ssm.py``; here a small dense LM, a small Mamba-2 LM
and live executors run on the card, the decode step from its CUDA graph.
The replay-input helpers are shared with ``tests/test_torch_kernels.py``;
K6's bf16 limits on y by its scale (``SSD_ROW_TOL``, ``SSD_MEAN_TOL``) and
its planted faults are ``chip_smoke.py``'s, loaded from the checkout.
"""

from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.gbrt import GBRT, GBRTConfig
from repro_torch.kernels.gbrt_predict.kernel import (
    blocked_route,
    gbrt_predict_blocked,
    gbrt_predict_blocked_plain,
    gbrt_predict_multi,
    gbrt_predict_multi_plain,
    step_table,
)
from repro_torch.kernels.gbrt_predict.ops import (
    gbrt_predict,
    gbrt_predict_configs,
    kernel_operands,
    multi_kernel_operands,
)
from repro_torch.kernels.linear_scan.kernel import (
    linear_scan_bsd,
    linear_scan_plain,
    scan_regime,
)
from repro_torch.kernels.linear_scan.ops import linear_scan, prefix_sum
from repro_torch.kernels.state_replay.kernel import state_replay

GBRT_TOL = 1e-4
SCAN_TOL = 5e-5
FOLD_TILE = 2048  # rows of the exact fold's shared-memory tile at D = 1


def replay_inputs(rng, R, nd, nc, cap, lpw, fill):
    nows = np.sort(rng.uniform(0.0, 50_000.0, size=R))
    guess = rng.integers(-1, nc + (1 if nd else 0), size=R)
    edge_col = nc if nd else -1
    busy0 = np.full((nc, cap), np.inf)
    last0 = np.full((nc, cap), -np.inf)
    cnt0 = rng.integers(0, fill + 1, size=nc)
    for c in range(nc):
        k = int(cnt0[c])
        last0[c, :k] = rng.uniform(-30_000.0, 20_000.0, size=k)
        busy0[c, :k] = last0[c, :k]
    kw = dict(edge_col=edge_col, lpw=lpw, t_idl=20_000.0)
    if nd:
        kw.update(ecomp=rng.uniform(100.0, 3000.0, size=(R, nd)),
                  h0=rng.uniform(0.0, 5000.0, size=nd),
                  nom_fixed=rng.integers(0, nd, size=R))
    if nc:
        kw.update(occw=rng.uniform(200.0, 4000.0, size=(R, nc)),
                  occc=rng.uniform(1200.0, 6000.0, size=(R, nc)),
                  busy0=busy0, last0=last0, cnt0=cnt0)
    return nows, guess, kw


def to_torch(nows, guess, kw):
    t = {k: (torch.as_tensor(v, dtype=torch.int32)
             if k in ("nom_fixed", "cnt0") else torch.as_tensor(v))
         if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return (torch.as_tensor(nows), torch.as_tensor(guess, dtype=torch.int32),
            t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on one")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_on_card(cuda_device, rng):
    """Each CUDA kernel against its plain version on the same inputs:
    float64 bit-equal, float32 within the reference tolerances."""
    x = rng.normal(size=(5000, 2)) * 100.0
    m = GBRT.fit(x[:400], x[:400, 0] * 2.0 + np.sin(x[:400, 1] / 30.0),
                 GBRTConfig(n_trees=50, max_depth=3))
    for dtype, tol in ((torch.float64, 0.0), (torch.float32, GBRT_TOL)):
        xt = torch.as_tensor(x, dtype=dtype)
        got = gbrt_predict(m, xt.to(cuda_device)).cpu()
        np.testing.assert_allclose(got.numpy(), gbrt_predict(m, xt).numpy(),
                                   rtol=tol, atol=tol)
        sizes = xt[:, 0].contiguous()
        mem = torch.tensor([1536.0, 2048.0], dtype=dtype)
        got = gbrt_predict_configs([m, m], mem.to(cuda_device),
                                   sizes.to(cuda_device)).cpu()
        want = gbrt_predict_configs([m, m], mem, sizes)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                                   atol=tol)
    xs = torch.as_tensor(rng.normal(size=(2, 256, 64)), dtype=torch.float32)
    a = torch.as_tensor(rng.uniform(0.1, 1.0, size=(2, 256, 64)),
                        dtype=torch.float32)
    y, s = linear_scan(xs.to(cuda_device), a.to(cuda_device))
    yp, sp = linear_scan_plain(xs, a)
    np.testing.assert_allclose(y.cpu().numpy(), yp.numpy(), atol=SCAN_TOL)
    d = torch.as_tensor(rng.normal(size=4097))
    assert torch.equal(prefix_sum(d.to(cuda_device)).cpu(), prefix_sum(d))
    nows, guess, kw = replay_inputs(rng, 2000, 3, 4, 64, True, 20)
    tn, tg, tkw = to_torch(nows, guess, kw)
    want = state_replay(tn, tg, **tkw)
    got = state_replay(tn.to(cuda_device), tg.to(cuda_device),
                       **{k: v.to(cuda_device) if torch.is_tensor(v) else v
                          for k, v in tkw.items()})
    for a_, b_ in zip(got, want):
        assert torch.equal(a_.cpu(), b_), "state_replay"
    assert kernels.launch_counts()["state_replay"] >= 1


def gbrt_data(rng, n_features):
    """400 seeded rows over ``n_features`` columns and a target that every
    column moves."""
    x = rng.normal(size=(400, n_features)) * 100.0
    y = sum(np.sin(x[:, f] / (20.0 + 10.0 * f)) * (f + 1.0)
            for f in range(n_features)) + x[:, 0] * 0.05
    return x, y


def gbrt_fit(rng, n_features, depth, n_trees, n_bins=64):
    """A seeded ensemble over ``n_features`` columns, each of them used."""
    return GBRT.fit(*gbrt_data(rng, n_features),
                    GBRTConfig(n_trees=n_trees, max_depth=depth,
                               n_bins=n_bins))


def gbrt_adversarial(breaks, rng, npd, n):
    """``chip_smoke.adversarial`` over ``n`` seeded sizes."""
    return SMOKE.adversarial(breaks, rng.normal(size=n) * 300.0, npd, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [0, 1, 4097, 65_536])
def test_gbrt_multi_table_on_card(cuda_device, rng, n, dtype):
    """K1's step table against the CPU plain walk, bit for bit: configs of
    depths 2-4 padded to one stack, a repeated model, and sizes at every
    break, its neighbours, NaN, +-inf and +-0.0."""
    models = [gbrt_fit(rng, 2, d, t) for d, t in [(2, 20), (3, 50), (4, 10)]]
    models.append(models[0])
    npd = np.float64 if dtype == torch.float64 else np.float32
    cpu = multi_kernel_operands(models, dtype)
    dev = multi_kernel_operands(models, dtype, cuda_device)
    BR = step_table(cpu[1]).breaks.numpy()
    sizes = torch.as_tensor(np.concatenate(
        [gbrt_adversarial(BR[c], rng, npd, n // 4 + 1) for c in range(4)])[:n])
    mem = torch.tensor([1280.0, 1536.0, 1792.0, 2048.0], dtype=dtype)
    want = gbrt_predict_multi_plain(sizes, mem, *cpu[3:5], *cpu[:3],
                                    depth=cpu[5])
    before = gbrt_predict_multi.launches
    got = gbrt_predict_multi(sizes.to(cuda_device), mem.to(cuda_device),
                             *dev[3:5], *dev[:3], depth=dev[5])
    torch.cuda.synchronize()
    assert SMOKE.bits_equal(got, want)
    assert gbrt_predict_multi.launches - before == (1 if n else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_configs", [1, 3, 6])
def test_gbrt_multi_table_config_counts_on_card(cuda_device, rng, n_configs):
    """K1 at config counts that are not a multiple of the lookup's four
    lockstep searches, bit-equal to the CPU plain walk in float64."""
    base = [gbrt_fit(rng, 2, d, t) for d, t in [(3, 40), (2, 15), (4, 8)]]
    models = [base[c % 3] for c in range(n_configs)]
    cpu = multi_kernel_operands(models)
    dev = multi_kernel_operands(models, torch.float64, cuda_device)
    BR = step_table(cpu[1]).breaks.numpy()
    sizes = torch.as_tensor(np.concatenate(
        [gbrt_adversarial(BR[c], rng, np.float64, 700)
         for c in range(n_configs)]))
    mem = torch.as_tensor(rng.uniform(1000.0, 3000.0, size=n_configs))
    want = gbrt_predict_multi_plain(sizes, mem, *cpu[3:5], *cpu[:3],
                                    depth=cpu[5])
    got = gbrt_predict_multi(sizes.to(cuda_device), mem.to(cuda_device),
                             *dev[3:5], *dev[:3], depth=dev[5])
    torch.cuda.synchronize()
    assert SMOKE.bits_equal(got, want)


@pytest.mark.cuda
def test_gbrt_tables_rebuilt_every_call_on_card(cuda_device, rng):
    """K1 and K2 with their tables' inputs (K1's memories, K2's leaves)
    changed between calls in place, so every call reuses the buffers of
    the last: eagerly, alternating two tables 20 times, and replayed from
    one CUDA graph (each lookup a programmatic dependent of its build), the
    bits of the CPU plain walk every time."""
    m = gbrt_fit(rng, 2, 3, 50)
    f, th, lv = kernel_operands(m, torch.float64, cuda_device)
    F1, TH1, LV1, LR1, BASE1, depth = multi_kernel_operands(
        [m, m], torch.float64, cuda_device)
    sizes = torch.as_tensor(
        gbrt_adversarial(step_table(th).breaks[0].cpu().numpy(), rng,
                         np.float64, 4097), device=cuda_device)
    x2 = torch.stack([sizes, sizes.flip(0)], 1).contiguous()
    mem = torch.empty(2, dtype=torch.float64, device=cuda_device)
    leaves = lv.clone()
    kw = dict(depth=3, lr=m.config.learning_rate, base=m.base)
    tables = [(torch.tensor([1280.0, 2048.0]), lv.cpu()),
              (torch.tensor([-50.0, 75.0]), lv.cpu() * -0.5 + 1.0)]
    wants = [(gbrt_predict_multi_plain(sizes.cpu(), mm, LR1.cpu(),
                                       BASE1.cpu(), F1.cpu(), TH1.cpu(),
                                       LV1.cpu(), depth=depth),
              gbrt_predict_blocked_plain(x2.cpu(), f.cpu(), th.cpu(), ll,
                                         **kw)) for mm, ll in tables]

    def calls():
        return (gbrt_predict_multi(sizes, mem, LR1, BASE1, F1, TH1, LV1,
                                   depth=depth),
                gbrt_predict_blocked(x2, f, th, leaves, **kw))

    for i in range(20):
        mem.copy_(tables[i % 2][0])
        leaves.copy_(tables[i % 2][1])
        got1, got2 = calls()
        assert SMOKE.bits_equal(got1, wants[i % 2][0]), f"K1, call {i}"
        assert SMOKE.bits_equal(got2, wants[i % 2][1]), f"K2, call {i}"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out1, out2 = calls()
    for i in range(6):
        mem.copy_(tables[i % 2][0])
        leaves.copy_(tables[i % 2][1])
        g.replay()
        torch.cuda.synchronize()
        assert SMOKE.bits_equal(out1, wants[i % 2][0]), f"K1, replay {i}"
        assert SMOKE.bits_equal(out2, wants[i % 2][1]), f"K2, replay {i}"


def _blocked_case(rng, dtype, n, n_features, n_bins=64):
    m = gbrt_fit(rng, n_features, 3, 60, n_bins)
    npd = np.float64 if dtype == torch.float64 else np.float32
    feats, thr, lvs = kernel_operands(m, dtype)
    br = step_table(thr).breaks.numpy()
    cols = [gbrt_adversarial(br[f], rng, npd, n) for f in range(n_features)]
    x = torch.as_tensor(np.stack(cols, 1).reshape(n, n_features))
    kw = dict(depth=3, lr=m.config.learning_rate, base=m.base)
    want = gbrt_predict_blocked_plain(x, feats, thr, lvs, **kw)
    return m, x, kw, step_table(thr).counts, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [0, 1, 4097, 65_536])
def test_gbrt_blocked_table_on_card(cuda_device, rng, n, dtype):
    """K2 at F = 2 takes its table route and is bit-equal to the CPU plain
    walk on the adversarial rows."""
    m, x, kw, counts, want = _blocked_case(rng, dtype, n, 2)
    assert blocked_route(counts) == "table"
    before = dict(gbrt_predict_blocked.routes)
    feats, thr, lvs = kernel_operands(m, dtype, cuda_device)
    got = gbrt_predict_blocked(x.to(cuda_device), feats, thr, lvs, **kw)
    torch.cuda.synchronize()
    assert SMOKE.bits_equal(got, want)
    assert gbrt_predict_blocked.routes["table"] - before["table"] == (
        1 if n else 0)
    assert gbrt_predict_blocked.routes["walk"] == before["walk"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["F3_table", "F4_walk"])
def test_gbrt_blocked_routes_on_card(cuda_device, rng, case, dtype):
    """K2's routes past F = 2: three coarse features fit a table; four
    features of ~60 breaks each exceed its 4,096 cells and take the walk.
    Each bit-equal to the CPU plain walk."""
    n_features, n_bins, route = {"F3_table": (3, 8, "table"),
                                 "F4_walk": (4, 64, "walk")}[case]
    m, x, kw, counts, want = _blocked_case(rng, dtype, 4097, n_features,
                                           n_bins)
    assert blocked_route(counts) == route
    before = dict(gbrt_predict_blocked.routes)
    feats, thr, lvs = kernel_operands(m, dtype, cuda_device)
    got = gbrt_predict_blocked(x.to(cuda_device), feats, thr, lvs, **kw)
    torch.cuda.synchronize()
    assert SMOKE.bits_equal(got, want)
    assert {k: gbrt_predict_blocked.routes[k] - before[k]
            for k in before} == {route: 1, ("walk" if route == "table"
                                            else "table"): 0}


@pytest.mark.cuda
def test_gbrt_blocked_rejects_ids_past_f_on_card(cuda_device, rng):
    """A model that tests feature 1, over one column on the card: K2 raises
    ValueError and launches nothing; and a thresholds tensor without a
    recorded step table (a copy) is refused too."""
    m = gbrt_fit(rng, 2, 3, 20)
    feats, thr, lvs = kernel_operands(m, torch.float64, cuda_device)
    kw = dict(depth=3, lr=m.config.learning_rate, base=m.base)
    x = torch.zeros((64, 1), dtype=torch.float64, device=cuda_device)
    before = gbrt_predict_blocked.launches
    with pytest.raises(ValueError, match="past x's 1 columns"):
        gbrt_predict_blocked(x, feats, thr, lvs, **kw)
    with pytest.raises(ValueError, match="no step table"):
        gbrt_predict_blocked(x.expand(64, 2).contiguous(), feats,
                             thr.clone(), lvs, **kw)
    assert gbrt_predict_blocked.launches == before


@pytest.mark.cuda
def test_walk_on_card(cuda_device, rng):
    """The decision walk kernel against its plain version, both policies."""
    from repro_torch.kernels.state_replay.kernel import (
        state_walk,
        state_walk_plain,
    )

    nows, guess, kw = replay_inputs(rng, 3000, 3, 4, 128, True, 30)
    R, nc, nd = 3000, 4, 3
    tn, _, tkw = to_torch(nows, guess, kw)
    tkw.pop("edge_col")
    tkw.pop("nom_fixed")
    tkw.update(
        elat=torch.as_tensor(rng.uniform(500.0, 4000.0, size=(R, nd))),
        latw=torch.as_tensor(rng.uniform(500.0, 3000.0, size=(R, nc))),
        latc=torch.as_tensor(rng.uniform(1500.0, 6000.0, size=(R, nc))),
        costc=torch.as_tensor(rng.choice([2e-6, 4e-6, 6e-6], size=(R, nc))),
        s0=torch.tensor(0.0, dtype=torch.float64), c_max=3e-6, alpha=0.05)
    for minlat in (True, False):
        args = dict(tkw, minlat=minlat, deadline=2500.0)
        want = state_walk_plain(tn, R - 7, **args)
        got = state_walk(tn.to(cuda_device), R - 7,
                         **{k: v.to(cuda_device) if torch.is_tensor(v) else v
                            for k, v in args.items()})
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_torch_serve_on_card_matches_cpu(cuda_device):
    """A small bursty stream served with the torch backend on the card is
    decision-identical to the numpy oracle on the CPU (floats within 1e-9)
    and runs every kernel of the path."""
    from repro_torch.core.decision import DecisionEngine, MinLatencyPolicy
    from repro_torch.core.fit import build_fleet_predictor, fit_app
    from repro_torch.core.runtime import PlacementRuntime, TwinBackend
    from repro_torch.core.workload import BurstyWorkload

    configs, fleet = (1280, 1536, 1792), {"edge0": 1.0, "edge1": 1.0,
                                           "edge2": 0.6}
    twin, models = fit_app("IR", seed=0, n_inputs=120, configs=configs)
    tasks = BurstyWorkload(rate_per_s=4.0, size_sampler=twin.sample_input,
                           burst_multiplier=8.0, mean_quiet_s=10.0,
                           mean_burst_s=6.0, seed=31).generate(3000)

    def serve(device, backend):
        pred = build_fleet_predictor(models, dict(fleet), configs=configs)
        eng = DecisionEngine(predictor=pred, device=device,
                             policy=MinLatencyPolicy(c_max=6e-6, alpha=0.05))
        rt = PlacementRuntime(eng, TwinBackend(
            twin, seed=11, edge_names=tuple(fleet), edge_speed=fleet))
        return rt, rt.serve_stream(tasks, chunk_size=1024,
                                   array_backend=backend)

    _, ref = serve("cpu", "numpy")
    kernels.reset_launch_counts()
    rt, res = serve(cuda_device, "torch")
    counts = kernels.launch_counts()
    assert list(ref.records.targets) == list(res.records.targets)
    for col in ("predicted_cold", "actual_cold", "feasible"):
        assert np.array_equal(getattr(ref.records, col),
                              getattr(res.records, col)), col
    for col in ("predicted_latency_ms", "predicted_cost", "allowed_cost",
                "actual_latency_ms"):
        np.testing.assert_allclose(getattr(res.records, col),
                                   getattr(ref.records, col), rtol=1e-9,
                                   atol=1e-12, err_msg=col)
    for k in ("gbrt_predict_multi", "linear_scan", "state_replay",
              "state_walk"):
        assert counts[k] > 0, k
    assert rt.stream_stats["residency"]["fallback_chunks"] == 0


ATTN_TOL = {torch.float32: 5e-5, torch.bfloat16: 3e-2}
# K5 in bf16, per (batch, head) row: the row's largest error within
# DEC_ROW_TOL of its largest |output|, as chip_smoke.py holds it
DEC_ROW_TOL = 2.0 ** -6


def _row_rel_err(got, want):
    """Largest over (batch, head) rows of max |got - want| / max |want|
    (inf where a zero row of ``want`` is not matched exactly)."""
    g, w = (t.double().cpu().reshape(-1, t.shape[-1]) for t in (got, want))
    err, scale = (g - w).abs().amax(-1), w.abs().amax(-1)
    ratio = torch.where(scale > 0, err / scale.clamp_min(1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
    return ratio.max().item()


@contextlib.contextmanager
def _one_cpu_thread():
    """The CPU oracle's sums in one fixed order: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# K4's card cases: (B, S, H, Hkv, D, causal, window)
K4_CASES = [(1, 32, 32, 8, 64, True, 0), (2, 100, 4, 2, 64, True, 24),
            (1, 96, 4, 4, 16, True, 0), (1, 256, 8, 1, 128, True, 40),
            (2, 64, 4, 2, 32, False, 0), (1, 70, 2, 1, 256, True, 0),
            (1, 50, 6, 3, 80, False, 17), (1, 200, 8, 2, 80, True, 0),
            (2, 150, 8, 2, 256, True, 64), (1, 40, 4, 2, 20, True, 0),
            (2, 9, 2, 1, 1, False, 0),
            (8, 781, 16, 16, 80, False, 0)]  # hubert-xlarge's encoder


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_on_card(cuda_device, rng, dtype):
    """K4 against its plain version on the card: causal, windowed and
    bidirectional, MQA/GQA/MHA, ragged key tiles, head dims 1 to 256 (20 and
    1 are not multiples of 8: the bf16 kernel stages them element by
    element); the long bidirectional bf16 case also row by row."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import flash_attention

    # nothing of an earlier test may still run on the card, and the oracle
    # sums in one fixed order on one CPU thread
    torch.cuda.synchronize()
    for B, S, H, Hkv, D, causal, window in K4_CASES:
        q = torch.as_tensor(rng.normal(size=(B, H, S, D)), dtype=dtype)
        k = torch.as_tensor(rng.normal(size=(B, Hkv, S, D)), dtype=dtype)
        v = torch.as_tensor(rng.normal(size=(B, Hkv, S, D)), dtype=dtype)
        with _one_cpu_thread():
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        before = flash_attention_bhsd.launches
        got = flash_attention_bhsd(q.to(cuda_device), k.to(cuda_device),
                                   v.to(cuda_device), causal=causal,
                                   window=window)
        torch.cuda.synchronize()
        assert flash_attention_bhsd.launches == before + 1
        err = (got.cpu().float() - want.float()).abs().max().item()
        if err > ATTN_TOL[dtype] and window == 0:
            exact = _softmax_f64(q, k, v, causal)
            pytest.fail(
                f"{(B, S, H, Hkv, D, causal)}: kernel vs plain {err}; "
                f"against a float64 softmax the kernel reads "
                f"{float((got.cpu().double() - exact).abs().max())}, the "
                f"CPU plain version "
                f"{float((want.double() - exact).abs().max())}")
        assert err <= ATTN_TOL[dtype], (B, S, H, Hkv, D, causal, window, err)
        if dtype == torch.bfloat16 and not causal and S >= 512:
            # a long bidirectional row's outputs are small (~sqrt(e / S)),
            # so the absolute limit is loose there: each row is also held
            # within DEC_ROW_TOL of its largest |output|, as chip_smoke.py
            # holds the encoder's rows
            rel = SMOKE.k4b_row_err((got.cpu(),), (want,))
            assert rel <= DEC_ROW_TOL, (B, S, H, Hkv, D, rel)
        # the (B, S, H, D) layout through strided views
        qs, ks, vs = (t.transpose(1, 2).contiguous().to(cuda_device)
                      for t in (q, k, v))
        got2 = flash_attention(qs, ks, vs, causal=causal, window=window)
        assert torch.equal(got2.transpose(1, 2).cpu(), got.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K4_CASES + [(1, 40, 4, 2, 64, True, 5, 30)],
                         ids=str)
def test_flash_attention_lse_on_card(cuda_device, case, dtype):
    """The row log-sum-exp K4 writes for K4b against the plain version's
    ``return_lse`` on the same card inputs, within ``chip_smoke.LSE_TOL``
    (+inf on both sides for a row that sees no key: in the last case the
    queries from 34 on, whose 5-key window lies past its 30 keys); the
    output bit-equal with and without it
    requested, and the lse written through (b, h) strides of a wider
    buffer."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_plain,
    )

    B, S, H, Hkv, D, causal, window = case[:7]
    Skv = case[7] if len(case) > 7 else S
    g = torch.Generator(device=cuda_device).manual_seed(S + D)
    q = torch.randn((B, H, S, D), generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn((B, Hkv, Skv, D), generator=g, device=cuda_device)
            .to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window)
    plain = flash_attention_bhsd(q, k, v, **kw)
    wide = torch.full((B, H + 1, S + 3), float("nan"), device=cuda_device)
    lse = wide[:, 1:, 2:S + 2]
    with_lse = flash_attention_bhsd(q, k, v, lse=lse, **kw)
    _, want = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(plain, with_lse)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    assert not torch.isnan(lse).any()
    live = torch.isfinite(want)
    assert float((lse[live] - want[live]).abs().max()) <= SMOKE.LSE_TOL, case
    assert torch.isnan(wide[:, 0]).all() and torch.isnan(wide[..., :2]).all()
    assert torch.isnan(wide[..., S + 2:]).all()
    assert bool(torch.isinf(want).any()) == (Skv < S)
    if Skv < S:
        assert (lse[..., Skv + window - 1:] == float("inf")).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_bf16_long_gqa_on_card(cuda_device, rng, D):
    """K4's tensor-core path at a long causal prefill with GQA G = 4
    (q (1, 32, 2048, D), k/v (1, 8, 2048, D)): many blocks per KV head,
    key tiles skipped past the diagonal, within 3e-2 of the plain version
    (computed on the card)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_plain,
    )

    q = torch.as_tensor(rng.normal(size=(1, 32, 2048, D)),
                        dtype=torch.bfloat16).to(cuda_device)
    k, v = (torch.as_tensor(rng.normal(size=(1, 8, 2048, D)),
                            dtype=torch.bfloat16).to(cuda_device)
            for _ in range(2))
    got = flash_attention_bhsd(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_TOL[torch.bfloat16], (D, err)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, FOLD_TILE - 1, FOLD_TILE, FOLD_TILE + 1, 4097,
                               65_537])
def test_linear_scan_fold_bit_equal_on_card(cuda_device, rng, n):
    """K3's exact fold (float64, a == 1: the surplus prefix) at lengths
    around its 2,048-row shared-memory tile and at the placement chunk's
    65,537 rows: bit-equal to the plain version's left fold."""
    x = torch.as_tensor(rng.normal(size=(1, n, 1)) * 1e-5)
    x[0, 0, 0] = 1.3e-3
    assert scan_regime(x, None) == "fold"
    y, s = linear_scan_bsd(x.to(cuda_device))
    yp, sp = linear_scan_plain(x)
    assert torch.equal(y.cpu(), yp) and torch.equal(s.cpu(), sp)


@pytest.mark.cuda
def test_linear_scan_fold_gated_f64_on_card(cuda_device, rng):
    """The exact fold, gated, over two 32-column slices (the second ragged,
    8 wide) and tiles of 32 rows: bit-equal to the plain version."""
    x = torch.as_tensor(rng.normal(size=(2, 300, 40)))
    a = torch.as_tensor(rng.uniform(0.1, 1.0, size=(2, 300, 40)))
    assert scan_regime(x, a) == "fold"
    y, s = linear_scan_bsd(x.to(cuda_device), a.to(cuda_device))
    yp, sp = linear_scan_plain(x, a)
    assert torch.equal(y.cpu(), yp) and torch.equal(s.cpu(), sp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D", [(2, 4096, 1024), (1, 1000, 64),
                                   (2, 300, 40), (3, 77, 5), (2, 0, 3)])
def test_linear_scan_chunked_on_card(cuda_device, rng, B, S, D):
    """K3's chunked scan (float32, gated: the RG-LRU regime) at the RG-LRU
    shape, at S not a multiple of the chunk, at D not a multiple of 32,
    within one chunk and with no rows (a zero state): within 5e-5 of the
    plain version."""
    x = torch.as_tensor(rng.normal(size=(B, S, D)), dtype=torch.float32)
    a = torch.as_tensor(rng.uniform(0.1, 1.0, size=(B, S, D)),
                        dtype=torch.float32)
    assert scan_regime(x, a) == "chunked"
    y, s = linear_scan_bsd(x.to(cuda_device), a.to(cuda_device))
    yp, sp = linear_scan_plain(x, a)
    np.testing.assert_allclose(y.cpu().numpy(), yp.numpy(), rtol=0,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(s.cpu().numpy(), sp.numpy(), rtol=0,
                               atol=SCAN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_on_card(cuda_device, rng, dtype):
    """K5 against its plain version on the card: ragged lengths, lengths
    above S (every slot valid), a length of 0, several splits of the slot
    axis and wide GQA groups."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_bhd,
        decode_attention_plain,
    )
    from repro_torch.kernels.decode_attention.ops import decode_attention

    cases = [(1, 32, 32, 8, 64), (4, 4096, 32, 8, 64), (3, 200, 8, 2, 128),
             (2, 600, 16, 1, 256), (2, 64, 12, 1, 80), (1, 33, 4, 4, 16)]
    for B, S, H, Hkv, D in cases:
        q = torch.as_tensor(rng.normal(size=(B, H, 1, D)), dtype=dtype)
        k = torch.as_tensor(rng.normal(size=(B, Hkv, S, D)), dtype=dtype)
        v = torch.as_tensor(rng.normal(size=(B, Hkv, S, D)), dtype=dtype)
        lengths = rng.integers(1, S + 1, size=B)
        lengths[0] = S + 3
        if B > 2:
            lengths[-1] = 0
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
        want = decode_attention_plain(q, k, v, lengths)
        got = decode_attention_bhd(q.to(cuda_device), k.to(cuda_device),
                                   v.to(cuda_device), lengths.to(cuda_device))
        torch.cuda.synchronize()
        err = (got.cpu().float() - want.float()).abs().max().item()
        assert err <= ATTN_TOL[dtype], (B, S, H, Hkv, D, err)
        if dtype == torch.bfloat16:
            rel = _row_rel_err(got, want)
            assert rel <= DEC_ROW_TOL, (B, S, H, Hkv, D, rel)
        if B > 2:
            assert not got[-1].any(), "a length of 0 gives 0"
        ks, vs = (t.transpose(1, 2).contiguous().to(cuda_device)
                  for t in (k, v))
        got2 = decode_attention(q.transpose(1, 2).to(cuda_device), ks, vs,
                                lengths.to(cuda_device))
        assert torch.equal(got2.transpose(1, 2).cpu(), got.cpu())


@pytest.mark.cuda
def test_lm_and_executor_on_card(cuda_device):
    """A small dense LM on the card against the same weights on the CPU
    (float32: K4/K5 vs their plain versions, cuBLAS vs CPU matmuls), the
    decode step replayed from its CUDA graph against the eager one (bf16,
    bit-equal), and a live executor's cold and warm starts. The wrappers
    count the eager launches alone; the graphs tally their replays (a warm
    execution replays its prefill graph and its decode graph)."""
    from repro_torch.configs import smoke_config
    from repro_torch.serving.engine import (
        DecodeGraph,
        make_compiled_steps,
        replayed_launches,
        reset_replayed_launches,
    )
    from repro_torch.serving.executors import LiveExecutor, SliceSpec

    cfg = smoke_config("llama3.2-1b")
    model, params, prefill_fn, decode_fn = make_compiled_steps(
        cfg, seed=0, device=cuda_device)
    cpu = {k: v.cpu() for k, v in params.items()}
    toks = torch.arange(12, dtype=torch.int32)[None].repeat(2, 1) % cfg.vocab
    lg, cg = model.prefill(params, {"tokens": toks.to(cuda_device)})
    lc, cc = model.prefill(cpu, {"tokens": toks})
    for step in range(4):  # past the 12-slot cache
        tok = torch.tensor([step, 3 * step], dtype=torch.int32)
        lg, cg = model.decode_step(params, cg, {"token": tok.to(cuda_device)})
        lc, cc = model.decode_step(cpu, cc, {"token": tok})
        assert (lg.cpu() - lc).abs().max().item() < 1e-4
    bf = cfg.with_updates(dtype="bfloat16")
    model, params, prefill_fn, decode_fn = make_compiled_steps(
        bf, seed=1, device=cuda_device)
    _, cache = prefill_fn(params, {"tokens": toks.to(cuda_device)})
    graph = DecodeGraph(decode_fn, params, cache)
    assert graph.launches_per_replay == {"decode_attention": cfg.n_layers}
    graph.load(cache)
    eager = {k: v.clone() for k, v in cache.items()}
    kernels.reset_launch_counts()
    reset_replayed_launches()
    for step in range(3):
        graph.token.fill_(step)
        got = graph.step().clone()
        want, eager = decode_fn(params, eager, {"token": torch.full(
            (2,), step, dtype=torch.int32, device=cuda_device)})
        assert torch.equal(got, want)
    counts = kernels.launch_counts()
    assert counts["decode_attention"] == 3 * cfg.n_layers  # the eager steps
    assert replayed_launches() == {"decode_attention": 3 * cfg.n_layers}
    ex = LiveExecutor(SliceSpec("s2", 2, tokens_per_step=4), bf,
                      device=cuda_device)
    r1 = ex.execute(64, 16.0)
    kernels.reset_launch_counts()
    reset_replayed_launches()
    r2 = ex.execute(64, 16.0)
    assert r1.cold and not r2.cold and r2.start_ms < r1.start_ms
    counts = kernels.launch_counts()
    # the prefill and every decode step are replays
    assert counts["flash_attention"] == counts["decode_attention"] == 0
    # one prefill, 64 / (2 x 4) decode steps
    assert replayed_launches() == {"flash_attention": cfg.n_layers,
                                   "decode_attention": 8 * cfg.n_layers}


@pytest.mark.cuda
def test_live_serve_on_card(cuda_device):
    """Calibrate-then-serve on the card with a small LM: the sequential
    serve and the concurrent one (one dispatcher thread per target, cold
    starts capturing prefill and decode graphs while other executors run).
    A capture tallies only its own thread's launches, so the graphs replay
    K4 (prefills) and K5 (decode steps) alone, whatever the other executors
    launched meanwhile."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.decision import MinLatencyPolicy
    from repro_torch.serving import (
        NetworkProfile,
        SliceSpec,
        calibrate_catalog,
        llm_workload,
        make_live_runtime,
    )
    from repro_torch.serving.engine import (
        replayed_launches,
        reset_replayed_launches,
    )

    cfg = smoke_config("llama3.2-1b").with_updates(dtype="bfloat16")
    specs = [SliceSpec("s2", 2, tokens_per_step=4),
             SliceSpec("s8", 8, tokens_per_step=4)]
    cat = calibrate_catalog(cfg, specs, n_tasks=6, n_cold=1, seed=0,
                            device=cuda_device)
    policy = MinLatencyPolicy(c_max=0.01, alpha=0.05)
    kernels.reset_launch_counts()
    res = make_live_runtime(cat, policy, t_idl_ms=30_000.0,
                            device=cuda_device).serve(
        llm_workload(25, rate_per_s=40.0, seed=1, mean_tokens=128))
    assert res.n == 25 and res.n_failed == 0
    assert np.isfinite(res.avg_actual_latency_ms)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0
    rt = make_live_runtime(cat, policy, t_idl_ms=30_000.0, n_edge_devices=3,
                           network=NetworkProfile(base_ms=2.0),
                           device=cuda_device)
    reset_replayed_launches()
    res = rt.serve_async(llm_workload(24, rate_per_s=40.0, seed=2,
                                      mean_tokens=128))
    assert res.n == 24 and res.n_failed == 0
    assert np.isfinite(res.avg_actual_latency_ms)
    replayed = replayed_launches()
    assert set(replayed) == {"flash_attention", "decode_attention"}
    assert replayed["flash_attention"] % cfg.n_layers == 0
    assert replayed["decode_attention"] % cfg.n_layers == 0


def ssd_inputs(rng, b, H, S, hd, ds, dtype):
    """Kernel-layout SSD inputs drawn as ``tests/test_kernels.py`` draws
    them, with B and C scaled by ds ** -0.5 so that C B^T has unit variance
    at any state width (the model's normalised projections are of that
    order)."""
    x = torch.as_tensor(rng.normal(size=(b, H, S, hd)), dtype=dtype)
    dt = torch.as_tensor(np.abs(rng.normal(size=(b, H, S))) * 0.5,
                         dtype=torch.float32)
    A = torch.as_tensor(-np.abs(rng.normal(size=H)) - 0.1,
                        dtype=torch.float32)
    B, C = (torch.as_tensor(rng.normal(size=(b, S, ds)) * ds ** -0.5,
                            dtype=dtype) for _ in range(2))
    return x, dt, A, B, C


def ssd_err(got, want) -> float:
    """Largest |got - want| / max(1, |want|): an absolute error up to 1, a
    relative one above (one bf16 ulp above |y| = 4 exceeds 3e-2)."""
    g, w = got.cpu().double(), want.cpu().double()
    return float(((g - w).abs() / w.abs().clamp_min(1.0)).max())


def max_abs(a, b) -> float:
    return float((a.cpu().double() - b.cpu().double()).abs().max())


SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_chip_smoke()


def assert_ssd_bf16_scale(got, want, case):
    """K6's bf16 y against the plain version's by its scale: each (batch,
    head) row within SSD_ROW_TOL of its largest |y|, the mean error within
    SSD_MEAN_TOL of the mean |y| (``chip_smoke.py``'s limits)."""
    row, mean = SMOKE.ssd_y_errs(got, want)
    assert row <= SMOKE.SSD_ROW_TOL and mean <= SMOKE.SSD_MEAN_TOL, (
        case, row, mean)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_on_card(cuda_device, rng, dtype):
    """K6 against its plain version on the card: the smoke head shape (hd 8,
    ds 16, chunks of 8), mamba2-780m's head shape at the serving prompt (one
    chunk of 32), padded multi-chunk and non-power-of-two chunks, ragged
    head-dim slices; y within 1e-4 in float32 and within 3e-2 of
    max(1, |y|) in bf16 (and within the bf16 limits by y's scale), the
    float32 state within 1e-4. The model layout
    through strided views is bit-equal to the kernel layout."""
    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_scan_bhsd,
        ssd_scan_plain,
    )
    from repro_torch.kernels.ssd_scan.ops import ssd

    cases = [(2, 16, 20, 8, 16, 8), (1, 48, 32, 64, 128, 128),
             (1, 48, 300, 64, 128, 128), (2, 4, 100, 64, 128, 128),
             (1, 3, 77, 40, 24, 16), (3, 2, 9, 16, 200, 64)]
    for b, H, S, hd, ds, chunk in cases:
        args = ssd_inputs(rng, b, H, S, hd, ds, dtype)
        dev_args = [t.to(cuda_device) for t in args]
        want_y, want_s = ssd_scan_plain(*dev_args, chunk=chunk)
        before = ssd_scan_bhsd.launches
        y, s = ssd_scan_bhsd(*dev_args, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_scan_bhsd.launches == before + 1
        assert y.dtype == dtype and s.dtype == torch.float32
        case = (b, H, S, hd, ds, chunk)
        y_err = ssd_err(y, want_y) if dtype == torch.bfloat16 \
            else max_abs(y, want_y)
        assert y_err <= SSD_TOL[dtype], (case, y_err)
        if dtype == torch.bfloat16:
            assert_ssd_bf16_scale(y, want_y, case)
        assert max_abs(s, want_s) <= 1e-4, (case, max_abs(s, want_s))
        x, dt, A, B, C = dev_args
        ys, ss = ssd(x.transpose(1, 2).contiguous(),
                     dt.transpose(1, 2).contiguous(), A, B, C, chunk=chunk)
        assert torch.equal(ys.transpose(1, 2), y) and torch.equal(ss, s)
    if dtype == torch.float32:
        # against the literal oracle at S = 300 (3 chunks): within the gap
        # the plain version itself has to ssd_ref on the CPU, plus a margin
        # of 1e-4, the kernel's own limit against the plain version
        from repro_torch.kernels.ssd_scan.ref import ssd_ref

        x, dt, A, B, C = ssd_inputs(rng, 1, 48, 300, 64, 128, dtype)
        model = (x.transpose(1, 2), dt.transpose(1, 2), A, B, C)
        ref_y, ref_s = ssd_ref(*model)
        plain_y, plain_s = ssd_scan_plain(x, dt, A, B, C, chunk=128)
        gap = max(max_abs(plain_y.transpose(1, 2), ref_y),
                  max_abs(plain_s, ref_s))
        y, s = ssd_scan_bhsd(*(t.to(cuda_device) for t in (x, dt, A, B, C)),
                             chunk=128)
        err = max(max_abs(y.transpose(1, 2), ref_y), max_abs(s, ref_s))
        assert err <= gap + SSD_TOL[dtype], (err, gap)


@pytest.mark.cuda
def test_mamba_lm_and_executor_on_card(cuda_device):
    """The smoke Mamba-2 LM on the card against the same weights on the CPU
    (float32: K6 vs its plain version, cuBLAS vs CPU matmuls) over a
    multi-chunk prefill and 4 decode steps; the decode step replayed from
    its CUDA graph against the eager one (bf16, bit-equal; the graph holds
    no kernel of the port, so it tallies no replayed launch); a live
    executor's cold and warm starts, a warm prefill replaying its graph's
    K6 launch per layer."""
    from repro_torch.configs import smoke_config
    from repro_torch.serving.engine import (
        DecodeGraph,
        make_compiled_steps,
        replayed_launches,
        reset_replayed_launches,
    )
    from repro_torch.serving.executors import LiveExecutor, SliceSpec

    cfg = smoke_config("mamba2-780m")
    model, params, prefill_fn, decode_fn = make_compiled_steps(
        cfg, seed=0, device=cuda_device)
    cpu = {k: v.cpu() for k, v in params.items()}
    toks = torch.arange(21, dtype=torch.int32)[None].repeat(2, 1) % cfg.vocab
    kernels.reset_launch_counts()
    lg, cg = model.prefill(params, {"tokens": toks.to(cuda_device)})
    assert kernels.launch_counts()["ssd_scan"] == cfg.n_layers
    lc, cc = model.prefill(cpu, {"tokens": toks})
    assert max_abs(lg, lc) < 1e-4
    for step in range(4):
        tok = torch.tensor([step, 3 * step], dtype=torch.int32)
        lg, cg = model.decode_step(params, cg, {"token": tok.to(cuda_device)})
        lc, cc = model.decode_step(cpu, cc, {"token": tok})
        assert max_abs(lg, lc) < 1e-4
    for key in ("state", "conv"):
        assert max_abs(cg[key], cc[key]) < 1e-4, key
    bf = cfg.with_updates(dtype="bfloat16")
    model, params, prefill_fn, decode_fn = make_compiled_steps(
        bf, seed=1, device=cuda_device)
    _, cache = prefill_fn(params, {"tokens": toks.to(cuda_device)})
    graph = DecodeGraph(decode_fn, params, cache)
    assert graph.launches_per_replay == {}
    graph.load(cache)
    eager = {k: v.clone() for k, v in cache.items()}
    reset_replayed_launches()
    for step in range(3):
        graph.token.fill_(step)
        got = graph.step().clone()
        want, eager = decode_fn(params, eager, {"token": torch.full(
            (2,), step, dtype=torch.int32, device=cuda_device)})
        assert torch.equal(got, want)
    assert all(torch.equal(graph.cache[k], eager[k]) for k in eager)
    assert replayed_launches() == {}
    ex = LiveExecutor(SliceSpec("s2", 2, tokens_per_step=4), bf,
                      device=cuda_device)
    r1 = ex.execute(64, 16.0)
    kernels.reset_launch_counts()
    reset_replayed_launches()
    r2 = ex.execute(64, 16.0)
    assert r1.cold and not r2.cold and r2.start_ms < r1.start_ms
    assert kernels.launch_counts()["ssd_scan"] == 0
    assert replayed_launches() == {"ssd_scan": cfg.n_layers}


# ------------------------------------------- the prefill graph, Griffin
# the kernels a prefill of each family launches, per layer of that kind
PREFILL_KERNELS = {"llama3.2-1b": {"flash_attention": "layers"},
                   "mamba2-780m": {"ssd_scan": "layers"},
                   "recurrentgemma-9b": {"linear_scan": "rec",
                                         "flash_attention": "attn"}}


def _layers_of(cfg, kind):
    from repro_torch.modeling.griffin import layer_kinds

    return cfg.n_layers if kind == "layers" else layer_kinds(cfg).count(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(PREFILL_KERNELS))
def test_prefill_graph_bit_equal_to_eager_on_card(cuda_device, arch):
    """The prefill captured in a CUDA graph (``PrefillGraph``) against the
    eager prefill, for each ported family at smoke width in bf16: logits
    and every cache tensor bit-equal, for the captured prompt and for a
    second prompt copied into the graph's tokens; its replays tallied
    apart from the wrappers' counts."""
    from repro_torch.configs import smoke_config
    from repro_torch.serving.engine import (
        PrefillGraph,
        make_compiled_steps,
        replayed_launches,
        reset_replayed_launches,
    )

    cfg = smoke_config(arch).with_updates(dtype="bfloat16")
    model, params, prefill_fn, _ = make_compiled_steps(
        cfg, seed=0, device=cuda_device)
    S = 24 if cfg.family != "hybrid" else cfg.attn_window + 8  # ring rolls
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab, (2, S), generator=gen,
                             dtype=torch.int32).to(cuda_device)
               for _ in range(2)]
    graph = PrefillGraph(prefill_fn, params, prompts[0])
    want = {k: _layers_of(cfg, kind)
            for k, kind in PREFILL_KERNELS[arch].items()}
    assert graph.launches_per_replay == want
    kernels.reset_launch_counts()
    reset_replayed_launches()
    for tokens in prompts:
        graph.tokens.copy_(tokens)
        logits, cache = graph.run()
        e_logits, e_cache = prefill_fn(params, {"tokens": tokens})
        assert torch.equal(logits, e_logits)
        assert set(cache) == set(e_cache)
        for k in e_cache:
            assert cache[k].dtype == e_cache[k].dtype, k
            assert torch.equal(cache[k], e_cache[k]), k
    assert replayed_launches() == {k: 2 * n for k, n in want.items()}
    # the wrappers count the two eager prefills alone
    counts = kernels.launch_counts()
    assert {k: counts[k] for k in want} == {k: 2 * n for k, n in want.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_griffin_shapes_hold_to_the_refs_on_card(
        cuda_device, rng, dtype):
    """K4 windowed and K5 at Griffin's head_dim 256 with MQA (16 query
    heads on one KV head) on the card, against their plain versions and the
    literal oracles ``attention_ref`` / ``decode_attention_ref`` (in the
    model's layout): a 640-token prefill under a 256-token window, and a
    decode over a 384-slot ring, full and partly filled."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    tol = ATTN_TOL[dtype]
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 640, h, 256)),
                               dtype=dtype).to(cuda_device)
               for h in (16, 1, 1))
    got = flash_attention(q, k, v, causal=True, window=256)
    for want in (attention_ref(q, k, v, causal=True, window=256),
                 flash_attention_plain_bshd(q, k, v, window=256)):
        assert max_abs(got, want) <= tol
    q = torch.as_tensor(rng.normal(size=(2, 1, 16, 256)),
                        dtype=dtype).to(cuda_device)
    kc, vc = (torch.as_tensor(rng.normal(size=(2, 384, 1, 256)),
                              dtype=dtype).to(cuda_device) for _ in range(2))
    lens = torch.tensor([384, 200], dtype=torch.int32, device=cuda_device)
    got = decode_attention(q, kc, vc, lens)
    assert max_abs(got, decode_attention_ref(q, kc, vc, lens)) <= tol


def flash_attention_plain_bshd(q, k, v, window):
    """K4's plain version on (B, S, H, D) tensors."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain,
    )

    return flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 window=window).transpose(1, 2)


@pytest.mark.cuda
def test_griffin_lm_and_executor_on_card(cuda_device):
    """The smoke Griffin LM on the card against the same weights on the CPU
    (float32: K3, K4 and K5 vs their plain versions, cuBLAS vs CPU
    matmuls) over a prefill past the window and 8 decode steps that wrap
    the ring; in bf16 the decode step replayed from its CUDA graph against
    the eager one (bit-equal, K5 once per attention layer per step); a live
    executor's cold and warm starts, a warm execution all replays."""
    from repro_torch.configs import smoke_config
    from repro_torch.modeling.griffin import layer_kinds
    from repro_torch.serving.engine import (
        DecodeGraph,
        make_compiled_steps,
        replayed_launches,
        reset_replayed_launches,
    )
    from repro_torch.serving.executors import LiveExecutor, SliceSpec

    cfg = smoke_config("recurrentgemma-9b")
    n_rec, n_attn = (layer_kinds(cfg).count(k) for k in ("rec", "attn"))
    model, params, prefill_fn, decode_fn = make_compiled_steps(
        cfg, seed=0, device=cuda_device)
    cpu = {k: v.cpu() for k, v in params.items()}
    S = cfg.attn_window + 12
    toks = torch.arange(S, dtype=torch.int32)[None].repeat(2, 1) % cfg.vocab
    kernels.reset_launch_counts()
    lg, cg = model.prefill(params, {"tokens": toks.to(cuda_device)})
    counts = kernels.launch_counts()
    assert counts["linear_scan"] == n_rec
    assert counts["flash_attention"] == n_attn
    lc, cc = model.prefill(cpu, {"tokens": toks})
    assert max_abs(lg, lc) < 1e-4
    for step in range(8):
        tok = torch.tensor([step, 3 * step], dtype=torch.int32)
        lg, cg = model.decode_step(params, cg, {"token": tok.to(cuda_device)})
        lc, cc = model.decode_step(cpu, cc, {"token": tok})
        assert max_abs(lg, lc) < 1e-4
    assert kernels.launch_counts()["decode_attention"] == 8 * n_attn
    for key in ("state", "conv", "k", "v"):
        assert max_abs(cg[key], cc[key]) < 1e-4, key
    bf = cfg.with_updates(dtype="bfloat16")
    model, params, prefill_fn, decode_fn = make_compiled_steps(
        bf, seed=1, device=cuda_device)
    _, cache = prefill_fn(params, {"tokens": toks.to(cuda_device)})
    graph = DecodeGraph(decode_fn, params, cache)
    assert graph.launches_per_replay == {"decode_attention": n_attn}
    graph.load(cache)
    eager = {k: v.clone() for k, v in cache.items()}
    for step in range(8):  # the ring wraps
        graph.token.fill_(step)
        got = graph.step().clone()
        want, eager = decode_fn(params, eager, {"token": torch.full(
            (2,), step, dtype=torch.int32, device=cuda_device)})
        assert torch.equal(got, want)
    assert all(torch.equal(graph.cache[k], eager[k]) for k in eager)
    ex = LiveExecutor(SliceSpec("s2", 2, tokens_per_step=4), bf,
                      device=cuda_device)
    r1 = ex.execute(64, 16.0)
    kernels.reset_launch_counts()
    reset_replayed_launches()
    r2 = ex.execute(64, 16.0)
    assert r1.cold and not r2.cold and r2.start_ms < r1.start_ms
    assert set(kernels.launch_counts().values()) == {0}
    assert replayed_launches() == {"linear_scan": n_rec,
                                   "flash_attention": n_attn,
                                   "decode_attention": 8 * n_attn}


# ---------------------------------------------------------------- K5, split-K
def _decode_case(rng, B, H, Hkv, S, D, dtype, lengths, device, transposed=False):
    """K5 on the card vs its plain version; returns the card's output."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_bhd,
        decode_attention_plain,
    )

    q = torch.as_tensor(rng.normal(size=(B, H, 1, D)), dtype=dtype)
    if transposed:  # the model's (B, S, Hkv, D) caches, viewed as (B, Hkv, S, D)
        k, v = (torch.as_tensor(rng.normal(size=(B, S, Hkv, D)),
                                dtype=dtype).transpose(1, 2) for _ in "kv")
    else:
        k, v = (torch.as_tensor(rng.normal(size=(B, Hkv, S, D)), dtype=dtype)
                for _ in "kv")
    lens = torch.as_tensor(lengths, dtype=torch.int32)
    want = decode_attention_plain(q, k, v, lens)
    kd, vd = k.to(device), v.to(device)
    if transposed:
        assert not kd.is_contiguous() and kd.stride(-1) == 1
    got = decode_attention_bhd(q.to(device), kd, vd, lens.to(device))
    torch.cuda.synchronize()
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= ATTN_TOL[dtype], (B, H, Hkv, S, D, lengths, err)
    if dtype == torch.bfloat16:
        rel = _row_rel_err(got, want)
        assert rel <= DEC_ROW_TOL, (B, H, Hkv, S, D, lengths, rel)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any(), "a length of 0 gives 0"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_split_boundaries_on_card(cuda_device, rng, dtype):
    """Lengths at k * chunk - 1, k * chunk and k * chunk + 1 of the split
    rule's chunk, at B=4, Hkv=8, S=4096 (16 splits of 256 slots on an
    H100)."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_splits,
        sm_count,
    )

    B, H, Hkv, S, D = 4, 32, 8, 4096, 64
    nsplit, chunk = decode_splits(B, Hkv, H // Hkv, S, sm_count(cuda_device))
    assert nsplit > 1
    for kk in (1, 2, nsplit - 1):
        lens = [kk * chunk - 1, kk * chunk, kk * chunk + 1, S + 9]
        _decode_case(rng, B, H, Hkv, S, D, dtype, lens, cuda_device)
    _decode_case(rng, B, H, Hkv, S, D, dtype, [0, 1, S, S - 1], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["drop_split", "extra_slot"])
def test_decode_attention_bf16_row_limit_sees_planted_faults_on_card(
        cuda_device, rng, fault):
    """The bf16 row limit is tight enough to fail a kernel that drops one
    split of the slot axis or lets one masked slot through at a 64-slot
    tile edge: each fault's output, computed plainly on the card, lies
    beyond the limit from the kernel's, which lies within it of the plain
    version (B=4, Hkv=8, S=4096)."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_bhd,
        decode_attention_plain,
        decode_splits,
        sm_count,
    )

    B, H, Hkv, S, D = 4, 32, 8, 4096, 64
    nsplit, chunk = decode_splits(B, Hkv, H // Hkv, S, sm_count(cuda_device))
    assert nsplit > 1
    q = torch.as_tensor(rng.normal(size=(B, H, 1, D)),
                        dtype=torch.bfloat16).to(cuda_device)
    k, v = (torch.as_tensor(rng.normal(size=(B, Hkv, S, D)),
                            dtype=torch.bfloat16).to(cuda_device) for _ in "kv")
    lens = torch.tensor([2 * chunk + 64, 3 * chunk, S - 64, 64],
                        dtype=torch.int32, device=cuda_device)
    got = decode_attention_bhd(q, k, v, lens)
    assert _row_rel_err(got, decode_attention_plain(q, k, v, lens)) \
        <= DEC_ROW_TOL
    pos = torch.arange(S, device=cuda_device)[None, :]
    valid = pos < lens.long()[:, None]
    if fault == "drop_split":
        valid &= (pos < chunk) | (pos >= 2 * chunk)
    else:
        valid = pos < lens.long()[:, None] + 1
    Gq = H // Hkv
    s = torch.einsum("bkgd,bksd->bkgs", q.float().reshape(B, Hkv, Gq, D),
                     k.float()) / D ** 0.5
    m = valid[:, None, None, :]
    s = torch.where(m, s, -2.0e38)
    p = torch.where(m, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    bad = (torch.einsum("bkgs,bksd->bkgd", p, v.float())
           / p.sum(-1, keepdim=True)).reshape(B, H, 1, D).bfloat16()
    assert _row_rel_err(bad, got) > DEC_ROW_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_decode_attention_groups_and_head_dims_on_card(cuda_device, rng,
                                                       dtype, G):
    """Every head dim of the port's configs and the edges of the padded
    widths, for each GQA group size; transposed cache views, a length of 0
    and one above S, one split (S = 48) and several (S = 700)."""
    for D in (16, 64, 80, 128, 256):
        for S in (48, 700):
            _decode_case(rng, 3, 2 * G, 2, S, D, dtype, [S + 3, 0, S // 2 + 1],
                         cuda_device, transposed=D % 32 == 16)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [32, 4096])
def test_decode_attention_graph_replay_on_card(cuda_device, rng, S):
    """A bf16 decode captured in a CUDA graph, replayed while ``lengths``
    changes on the device, equals the eager call at each length (the split
    rule reads no lengths)."""
    from repro_torch.kernels.decode_attention.kernel import decode_attention_bhd

    B, H, Hkv, D = 4, 32, 8, 64
    bf = torch.bfloat16
    q = torch.as_tensor(rng.normal(size=(B, H, 1, D)), dtype=bf).to(cuda_device)
    k, v = (torch.as_tensor(rng.normal(size=(B, Hkv, S, D)), dtype=bf)
            .to(cuda_device) for _ in "kv")
    lens = torch.full((B,), S, dtype=torch.int32, device=cuda_device)
    out = torch.empty_like(q)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_bhd(q, k, v, lens, out=out)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        decode_attention_bhd(q, k, v, lens, out=out)
    for new in ([S + 1, 1, S // 2, 0], [3, S, S - 1, 17], [S, S, S, S]):
        lens.copy_(torch.as_tensor(new, dtype=torch.int32))
        g.replay()
        eager = decode_attention_bhd(q, k, v, lens)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), new


# ------------------------------------------------------------ the walk
def walk_inputs(rng, R, nd, nc, cap, lpw, fill, ties=False):
    """Random walk inputs as CPU tensors: the replay inputs plus latency and
    cost columns; ``ties`` rounds arrivals and occupancies to coarse grids so
    that completions (and so `last`) repeat."""
    nows, _, kw = replay_inputs(rng, R, nd, nc, cap, lpw, fill)
    if ties:
        nows = np.round(nows / 500.0) * 500.0
        if nc:
            kw["occw"] = np.round(kw["occw"] / 100.0) * 100.0
            kw["occc"] = kw["occw"] + 1000.0
    tn, _, tkw = to_torch(nows, np.zeros(R, np.int64), kw)
    tkw.pop("edge_col")
    if lpw or not nd:
        tkw.pop("nom_fixed", None)
    if nd:
        tkw["elat"] = torch.as_tensor(rng.uniform(500.0, 4000.0, size=(R, nd)))
    if nc:
        latw = rng.uniform(500.0, 3000.0, size=(R, nc))
        tkw.update(latw=torch.as_tensor(latw),
                   latc=torch.as_tensor(latw + rng.uniform(0.0, 3000.0,
                                                           size=(R, nc))),
                   costc=torch.as_tensor(rng.choice([2e-6, 4e-6, 6e-6],
                                                    size=(R, nc))))
    tkw.update(s0=torch.tensor(0.0, dtype=torch.float64), c_max=3e-6,
               alpha=0.05, deadline=2500.0)
    return tn, tkw


def _walk_case(tn, n, tkw, device, minlat):
    from repro_torch.kernels.state_replay.kernel import (
        state_walk,
        state_walk_plain,
    )

    args = dict(tkw, minlat=minlat)
    want = state_walk_plain(tn, n, **args)
    got = state_walk(tn.to(device), n,
                     **{k: v.to(device) if torch.is_tensor(v) else v
                        for k, v in args.items()})
    assert torch.equal(got[0].cpu(), want[0]), "codes"
    assert torch.equal(got[1].cpu(), want[1]), "overflow flags"
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("minlat", [True, False])
@pytest.mark.parametrize("case", ["lpw", "fixed", "no_edge", "nc1", "nc8",
                                  "overflow", "ties"])
def test_walk_cases_on_card(cuda_device, rng, case, minlat):
    """The walk bit-equal to its plain version: least-predicted-wait and
    fixed nominations, no edge fleet (MinLatency's every-target fallback),
    one and eight configs, pools that overflow (flags equal), equal
    completions (ties in `last`), and n < R pad rows, under both
    policies."""
    R, nd, nc, cap, lpw, fill, ties = 1500, 3, 4, 128, True, 30, False
    if case == "fixed":
        lpw = False
    elif case == "no_edge":
        nd = 0
    elif case == "nc1":
        nc = 1
    elif case == "nc8":
        nc, cap = 8, 64
    elif case == "overflow":
        cap, fill = 16, 14
    elif case == "ties":
        ties = True
    tn, tkw = walk_inputs(rng, R, nd, nc, cap, lpw, fill, ties)
    code, ovf = _walk_case(tn, R - 5, tkw, cuda_device, minlat)
    assert (code[R - 5:] == -1).all()
    if case == "overflow":
        assert ovf.any()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["1", "tile-1", "tile", "tile+1", "65536"])
def test_walk_row_counts_on_card(cuda_device, rng, rows):
    """Row counts around the input ring's tile (``walk_ring_rows``), and a
    whole 65,536-row chunk, bit-equal to the plain version."""
    from repro_torch.kernels.state_replay.kernel import walk_ring_rows

    nd, nc = 3, 4
    tile = walk_ring_rows(nd, nc)
    n = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "65536": 65536}[rows]
    tn, tkw = walk_inputs(rng, n, nd, nc, 512, True, 20)
    _walk_case(tn, n, tkw, cuda_device, True)


@pytest.mark.cuda
def test_launches_at_other_sizes_from_other_threads_on_card(cuda_device, rng):
    """Shards and planner candidates in threads launch the walk, the replay
    and K1 at once, each at its own shared-memory size (fleets of 1-4
    devices, pools of 256-2048 slots, 1-6 configs): every launch runs and
    equals its plain version. A launch must never find its function's
    shared-memory limit set under its own size by another thread."""
    import threading

    from repro_torch.kernels.state_replay.kernel import (
        smem_bytes,
        state_replay_plain,
        state_walk,
        state_walk_plain,
    )

    shapes = [(1, 1024, 1), (4, 256, 6), (2, 2048, 3), (3, 512, 4)]
    assert len({smem_bytes(nd, 4, cap) for nd, cap, _ in shapes}) == 4
    base = [gbrt_fit(rng, 2, d, t) for d, t in [(3, 40), (2, 15), (4, 8)]]
    dev = lambda kw: {k: v.to(cuda_device) if torch.is_tensor(v) else v
                      for k, v in kw.items()}
    jobs = []
    for nd, cap, C in shapes:
        tn, tkw = walk_inputs(rng, 1500, nd, 4, cap, True, 30)
        walk_kw = dict(tkw, minlat=True)
        nows, guess, kw = replay_inputs(rng, 1500, nd, 4, cap, True, 30)
        rn, rg, rkw = to_torch(nows, guess, kw)
        models = [base[c % 3] for c in range(C)]
        cpu = multi_kernel_operands(models)
        ops = multi_kernel_operands(models, torch.float64, cuda_device)
        sizes = torch.as_tensor(rng.normal(size=5000) * 300.0)
        mem = torch.as_tensor(rng.uniform(1000.0, 3000.0, size=C))
        want = (state_walk_plain(tn, 1500, **walk_kw),
                state_replay_plain(rn, rg, **rkw),
                gbrt_predict_multi_plain(sizes, mem, *cpu[3:5], *cpu[:3],
                                         depth=cpu[5]))
        calls = (
            lambda tn=tn.to(cuda_device), kw=dev(walk_kw):
                state_walk(tn, 1500, **kw),
            lambda rn=rn.to(cuda_device), rg=rg.to(cuda_device),
                   kw=dev(rkw): state_replay(rn, rg, **kw),
            lambda s=sizes.to(cuda_device), m=mem.to(cuda_device), o=ops:
                gbrt_predict_multi(s, m, *o[3:5], *o[:3], depth=o[5]))
        jobs.append((calls, want))
    start = threading.Barrier(len(jobs))
    outs = [[] for _ in jobs]
    errors = []

    def run(i):
        try:
            start.wait()
            for _ in range(100):
                outs[i].append(tuple(call() for call in jobs[i][0]))
        except Exception as e:  # noqa: BLE001 - re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    for (_, want), got in zip(jobs, outs):
        assert len(got) == 100
        for walk, replay, k1 in got:
            assert all(torch.equal(a.cpu(), b) for a, b in zip(walk, want[0]))
            assert all(torch.equal(a.cpu(), b)
                       for a, b in zip(replay, want[1]))
            assert SMOKE.bits_equal(k1, want[2])


@pytest.mark.cuda
def test_walk_chain_floor_on_card(cuda_device):
    """The chain-floor probe runs its R steps: thread 0's chain ends at
    R x inc, every warp folds each step's value."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.state_replay.kernel import walk_warps

    warps, R = walk_warps(4), 1000
    out = torch.empty(1 + warps, dtype=torch.float64, device=cuda_device)
    fn = _build.function("state_replay", "state_walk_chain_floor",
                         [_build.P, _build.F64, _build.I32, _build.I32,
                          _build.P])
    _build.check(fn(_build.ptr(out), 0.5, R, warps, _build.stream_of(out)),
                 "state_walk_chain_floor")
    torch.cuda.synchronize()
    assert out[0].item() == 0.5 * R
    assert (out[1:] == 0.5 * R * (R + 1) / 2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [0, 3, 200])
def test_walk_layout_mirrors_the_library_on_card(cuda_device, nd):
    """The host's mirror of the walk's launch (warps, ring rows, scan split,
    shared memory), which sizes the pools and ``max_pool_cap``, equals what
    the built library computes for the launch, at every config count up to
    the limit of 32 and at the CPU layout tests' shapes."""
    from repro_torch.kernels.state_replay.kernel import (
        walk_launch_layout,
        walk_ring_rows,
        walk_smem_bytes,
        walk_split,
        walk_warps,
    )

    shapes = [(nd, nc, cap) for nc in range(33) for cap in (8, 512, 2048)]
    shapes += [(3, 4, 2048), (0, 4, 512), (3, 0, 0), (3, 8, 1024),
               (3, 9, 512), (3, 32, 8), (200, 4, 64)]
    for d, nc, cap in shapes:
        mirror = (walk_warps(nc), walk_ring_rows(d, nc), walk_split(nc),
                  walk_smem_bytes(d, nc, cap))
        assert walk_launch_layout(d, nc, cap) == mirror, (d, nc, cap)


# ------------------------------------------------------------ the replay
REPLAY_CASES = {
    # name: (R, nd, nc, cap, lpw, fill, code probabilities or a rule)
    "dominant": (3000, 3, 4, 512, True, 40, "dominant"),
    "min_cost": (3000, 3, 4, 512, True, 40, "edge"),
    "empty_pools": (2000, 3, 4, 256, True, 0, None),
    "full_pools": (2000, 3, 4, 16, True, 16, None),
    "nd0": (1500, 0, 4, 256, True, 30, None),
    "nd1": (1500, 1, 4, 256, True, 30, None),
    "nd3_fixed": (1500, 3, 4, 256, False, 30, None),
    "nd5": (1500, 5, 2, 128, True, 20, None),
    "nd40": (700, 40, 2, 64, True, 20, None),
    "nc1": (2000, 3, 1, 512, True, 100, "dominant"),
    "nc8": (1500, 3, 8, 256, True, 30, None),
    "nc32": (1200, 3, 32, 64, True, 20, None),
    "ties": (2500, 3, 4, 256, True, 30, "ties"),
}


def _replay_case(rng, case):
    R, nd, nc, cap, lpw, fill, rule = REPLAY_CASES[case]
    nows, guess, kw = replay_inputs(rng, R, nd, nc, cap, lpw, fill)
    edge_col = nc if nd else -1
    if rule == "dominant":   # one config takes 80% of the rows
        guess = np.where(rng.uniform(size=R) < 0.8, 0, guess)
    elif rule == "edge":     # MinCost's codes: every row to the edge
        guess = np.full(R, edge_col)
    elif rule == "ties":     # coarse grids: completions (so `last`) repeat
        nows = np.round(nows / 500.0) * 500.0
        kw["occw"] = np.round(kw["occw"] / 100.0) * 100.0
        kw["occc"] = kw["occw"] + 1000.0
    if case == "full_pools":
        kw["cnt0"] = np.full(nc, cap)
        kw["last0"] = rng.uniform(-30_000.0, 20_000.0, size=(nc, cap))
        kw["busy0"] = kw["last0"].copy()
    return to_torch(nows, guess, kw)


def _replay_on_card(tn, tg, tkw, device):
    from repro_torch.kernels.state_replay.kernel import state_replay_plain

    want = state_replay_plain(tn, tg, **tkw)
    before = state_replay.launches
    got = state_replay(tn.to(device), tg.to(device),
                       **{k: v.to(device) if torch.is_tensor(v) else v
                          for k, v in tkw.items()})
    torch.cuda.synchronize()
    assert state_replay.launches == before + 1
    for field, a_, b_ in zip(got._fields, got, want):
        assert torch.equal(a_.cpu(), b_), field
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replay_cases_on_card(cuda_device, rng, case):
    """The replay bit-equal to ``state_replay_plain`` in every output (hb,
    nom, h_fin, cold, pools, counts, overflow): one config taking 80% of
    the rows (a long dispatch chain), all-edge MinCost codes (config chains
    empty), empty pools, full pools (every cold start overflows: no write,
    the chain goes on), no edge fleet, one, three (fixed nominations), five
    and forty devices (register and shared-memory horizons), one, eight and
    32 configs, repeated completions; several segments each."""
    tn, tg, tkw = _replay_case(rng, case)
    want = _replay_on_card(tn, tg, tkw, cuda_device)
    if case == "full_pools":
        assert want.overflow.all()
    if case == "min_cost":
        assert not want.overflow.any() and (want.cnt == tkw["cnt0"]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(0, 0, 0, 0), (0, 0, 1, 0), (1, 1, 1, 1)])
def test_replay_skip_flags_on_card(cuda_device, rng, flags):
    """The walk's overflow flags as ``skip``: all clear, the pass is the
    plain version's bit for bit; any set, the kernel launches (one count)
    and writes nothing, so the final pools keep what they held."""
    from repro_torch.kernels.state_replay.kernel import state_replay_plain

    tn, tg, tkw = _replay_case(rng, "dominant")
    dev = {k: v.to(cuda_device) if torch.is_tensor(v) else v
           for k, v in tkw.items()}
    nc, cap = tkw["busy0"].shape
    out = (torch.full((nc, cap), 7.0, dtype=torch.float64,
                      device=cuda_device),
           torch.full((nc, cap), 7.0, dtype=torch.float64,
                      device=cuda_device),
           torch.full((nc,), 7, dtype=torch.int32, device=cuda_device))
    skip = torch.tensor(flags, dtype=torch.int32, device=cuda_device)
    before = state_replay.launches
    got = state_replay(tn.to(cuda_device), tg.to(cuda_device), **dev,
                       out=out, skip=skip)
    torch.cuda.synchronize()
    assert state_replay.launches == before + 1
    if any(flags):
        assert (out[0] == 7.0).all() and (out[1] == 7.0).all()
        assert (out[2] == 7).all() and not got.overflow.any()
    else:
        want = state_replay_plain(tn, tg, **tkw)
        for field, a_, b_ in zip(got._fields, got, want):
            assert torch.equal(a_.cpu(), b_), field


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 511, 512, 513, 65536])
def test_replay_row_counts_on_card(cuda_device, rng, rows):
    """Row counts around the 512-row segment, and a whole chunk."""
    nows, guess, kw = replay_inputs(rng, rows, 3, 4, 512, True, 30)
    guess = np.where(rng.uniform(size=rows) < 0.8, 2, guess)
    _replay_on_card(*to_torch(nows, guess, kw), cuda_device)


@pytest.mark.cuda
def test_replay_chain_floor_on_card(cuda_device):
    """The replay's chain-floor probe runs its steps: thread 0's chain ends
    at steps x inc, every warp folds each step's value."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.state_replay.kernel import replay_warps

    warps, R = replay_warps() - 1, 1000
    out = torch.empty(1 + warps, dtype=torch.float64, device=cuda_device)
    fn = _build.function("state_replay", "state_replay_chain_floor",
                         [_build.P, _build.F64, _build.I32, _build.I32,
                          _build.P])
    _build.check(fn(_build.ptr(out), 0.5, R, warps, _build.stream_of(out)),
                 "state_replay_chain_floor")
    torch.cuda.synchronize()
    assert out[0].item() == 0.5 * R
    assert (out[1:] == 0.5 * R * (R + 1) / 2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [0, 1, 3, 40])
def test_replay_layout_mirrors_the_library_on_card(cuda_device, nd):
    """The host's mirror of the replay's launch (warps, segment rows,
    scanners per pool, shared memory) equals what the built library
    computes, at every config count up to 32."""
    from repro_torch.kernels.state_replay.kernel import (
        REPLAY_SPLIT,
        replay_launch_layout,
        replay_ring_rows,
        replay_warps,
        smem_bytes,
    )

    for nc in range(33):
        for cap in (8, 512, 2048):
            mirror = (replay_warps(), replay_ring_rows(nd), REPLAY_SPLIT,
                      smem_bytes(nd, nc, cap))
            assert replay_launch_layout(nd, nc, cap) == mirror, (nd, nc, cap)


# ------------------------------------------------------------------ K6
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 300, 4096])
def test_ssd_scan_row_counts_on_card(cuda_device, rng, dtype, S):
    """K6 at mamba2-780m's head shape (hd 64, ds 128, chunk 128) with S
    around the chunk (1, Q - 1, Q, Q + 1), at 300 and 4096 rows: y and
    state against the plain version at SSD_TOL (bf16 y also by its scale),
    one launch count per call on either route."""
    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_scan_bhsd,
        ssd_scan_plain,
    )

    args = [t.to(cuda_device) for t in ssd_inputs(rng, 1, 4, S, 64, 128,
                                                   dtype)]
    want_y, want_s = ssd_scan_plain(*args, chunk=128)
    before = ssd_scan_bhsd.launches
    y, s = ssd_scan_bhsd(*args, chunk=128)
    torch.cuda.synchronize()
    assert ssd_scan_bhsd.launches == before + 1
    y_err = ssd_err(y, want_y) if dtype == torch.bfloat16 \
        else max_abs(y, want_y)
    assert y_err <= SSD_TOL[dtype], (S, y_err)
    if dtype == torch.bfloat16:
        assert_ssd_bf16_scale(y, want_y, S)
    assert max_abs(s, want_s) <= 1e-4, (S, max_abs(s, want_s))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["hi_only", "drop_tile", "zero_group"])
@pytest.mark.parametrize("S", [32, 300])
def test_ssd_scan_bf16_limits_see_planted_faults_on_card(cuda_device, rng,
                                                         fault, S):
    """The bf16 limits by y's scale fail a kernel that takes scores x from
    the hi bf16 term alone, drops a diagonal score tile or zeroes a head
    group: the fault's y, computed plainly on the card, lies beyond one of
    them from the kernel's, which lies within both of the plain version's
    (mamba2-780m's head shape, 48 heads, one chunk and three)."""
    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_scan_bhsd,
        ssd_scan_plain,
    )

    args = [t.to(cuda_device) for t in ssd_inputs(rng, 1, 48, S, 64, 128,
                                                   torch.bfloat16)]
    y, _ = ssd_scan_bhsd(*args, chunk=128)
    assert_ssd_bf16_scale(y, ssd_scan_plain(*args, chunk=128)[0], S)
    row, mean = SMOKE.ssd_y_errs(SMOKE.ssd_planted(*args, 128, fault), y)
    assert row > SMOKE.SSD_ROW_TOL or mean > SMOKE.SSD_MEAN_TOL, (row, mean)


# ------------------------------------------------------------------ K4
def _softmax_f64(q, k, v, causal):
    """Attention in float64 on the CPU: the distance of a float32 output
    from it is that output's own rounding."""
    qd, kd, vd = (t.cpu().double() for t in (q, k, v))
    B, H, S, D = qd.shape
    G = H // kd.shape[1]
    kd, vd = kd.repeat_interleave(G, 1), vd.repeat_interleave(G, 1)
    s = qd @ kd.transpose(2, 3) / D ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    return torch.softmax(s, -1) @ vd


@pytest.mark.cuda
def test_flash_attention_f32_bit_stable_after_live_serve_on_card(
        cuda_device, rng):
    """K4 in float32 at the case that failed now and then in full card runs,
    (B, S, H, Hkv, D) = (1, 32, 32, 8, 64) causal, launched 100 times after
    a live serve in the same process: every output has the same bits, and
    each lies as close to a float64 softmax as the CPU plain version."""
    from repro_torch.core.decision import MinLatencyPolicy
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_plain,
    )
    from repro_torch.configs import smoke_config
    from repro_torch.serving import (
        SliceSpec,
        calibrate_catalog,
        llm_workload,
        make_live_runtime,
    )

    cfg = smoke_config("llama3.2-1b").with_updates(dtype="bfloat16")
    cat = calibrate_catalog(cfg, [SliceSpec("s2", 2, tokens_per_step=4),
                                  SliceSpec("s4", 4, tokens_per_step=4)],
                            n_tasks=3, n_cold=1, seed=0, device=cuda_device)
    rt = make_live_runtime(cat, MinLatencyPolicy(c_max=0.004, alpha=0.02),
                           device=cuda_device)
    assert rt.serve(llm_workload(8, rate_per_s=20.0, seed=3)).n == 8
    q = torch.as_tensor(rng.normal(size=(1, 32, 32, 64)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(1, 8, 32, 64)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(1, 8, 32, 64)), dtype=torch.float32)
    qc, kc, vc = (t.to(cuda_device) for t in (q, k, v))
    outs = [flash_attention_bhsd(qc, kc, vc, causal=True).cpu()
            for _ in range(100)]
    first = outs[0]
    differ = [i for i, o in enumerate(outs) if not torch.equal(o, first)]
    exact = _softmax_f64(q, k, v, True)
    want = flash_attention_plain(q, k, v, causal=True)
    d_got = float((first.double() - exact).abs().max())
    d_want = float((want.double() - exact).abs().max())
    assert not differ, (differ, d_got, d_want)
    assert float((first - want).abs().max()) <= ATTN_TOL[torch.float32], (
        d_got, d_want)


def _stt_planner_fixture():
    """The 600-task STT trace and 3 candidates of ``tests/test_planner.py``
    (fleets of 1-3 devices, edge-only), in the port's types."""
    from repro_torch.core.workload import PoissonWorkload
    from repro_torch.planner import Candidate, PolicySpec
    from repro_torch.planner.candidates import fitted
    from repro_torch.trace import Trace

    configs = (1280, 1536, 1792, 2048)
    twin, _ = fitted("STT", seed=0, n_inputs=120, configs=configs)
    tasks = PoissonWorkload(rate_per_s=0.12, size_sampler=twin.sample_input,
                            seed=5).generate(600)
    pol = PolicySpec(kind="min_latency", c_max=0.0)
    cands = [Candidate.make(f"fleet-{k}", k, policy=pol,
                            cloud_configs=configs, chunk_size=256,
                            device_rate_per_hour=0.05) for k in (1, 2, 3)]
    return Trace.from_tasks(tasks, app="STT"), cands, configs


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [
    dict(parallel=False), dict(parallel=True),
    dict(parallel=True, use_processes=True)],
    ids=["sequential", "thread", "process"])
def test_planner_modes_on_card(cuda_device, mode):
    """The planner on the card (``device=None``: the card) in each mode
    ranks the fixture's candidates as the numpy oracle on the CPU does, n
    and attainment identical and every float within 1e-9; each shard ran
    K1 once per chunk and at least one walk and replay. Process mode spawns
    its children, which build their runtimes on the card."""
    from repro_torch.planner import SLO, Planner

    trace, cands, configs = _stt_planner_fixture()
    slo = SLO(latency_ms=40_000.0, target=0.95)
    ref = Planner(trace, slo, fit_configs=configs, array_backend="numpy",
                  device="cpu").plan(cands, parallel=False)
    planner = Planner(trace, slo, fit_configs=configs)
    got = planner.plan(cands, **mode)
    assert got.mode == ("sequential" if not mode["parallel"] else
                        "process" if mode.get("use_processes") else "thread")
    assert got.best.candidate.name == ref.best.candidate.name == "fleet-2"
    assert [s.candidate.name for s in got.scores] == \
        [s.candidate.name for s in ref.scores]
    for a, b in zip(ref.scores, got.scores):
        assert (a.n, a.attainment, a.meets_slo) == (b.n, b.attainment,
                                                    b.meets_slo)
        for f in ("cloud_cost", "fleet_cost", "mean_latency_ms",
                  "p99_latency_ms", "makespan_ms"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-9, err_msg=f)
    for shard, st in planner.last_sharded.stream_stats.items():
        launches = st["launches"]
        assert launches["gbrt_predict_multi"] == st["chunks"], shard
        assert launches["state_walk"] >= 1 and launches["state_replay"] >= 1
        assert st["residency"]["fallback_chunks"] == 0


@pytest.mark.cuda
def test_trace_capture_and_replay_on_card(cuda_device, tmp_path):
    """A card stream captured with ``keep_inputs=True``, saved as JSONL and
    loaded back, replays to bit-identical records on the card."""
    from repro_torch.core.decision import DecisionEngine, MinLatencyPolicy
    from repro_torch.core.fit import build_fleet_predictor, fit_app
    from repro_torch.core.runtime import PlacementRuntime, TwinBackend
    from repro_torch.trace import TraceWorkload, capture, load

    configs, fleet = (1280, 1536, 1792), {"edge0": 1.0, "edge1": 1.0,
                                           "edge2": 0.6}
    twin, models = fit_app("IR", seed=0, n_inputs=120, configs=configs)

    def runtime():
        pred = build_fleet_predictor(models, dict(fleet), configs=configs)
        eng = DecisionEngine(predictor=pred, array_backend="torch",
                             policy=MinLatencyPolicy(c_max=6e-6, alpha=0.05))
        return PlacementRuntime(eng, TwinBackend(
            twin, seed=11, edge_names=tuple(fleet), edge_speed=fleet))

    res = runtime().serve_stream(twin.poisson(seed=3).chunks(3000, 1024),
                                 keep_inputs=True)
    capture(res, app="IR").save(tmp_path / "ir.jsonl")
    rep = runtime().serve_stream(
        TraceWorkload(load(tmp_path / "ir.jsonl")).chunks(chunk_size=1024))
    assert list(rep.records.targets) == list(res.records.targets)
    for col in ("actual_latency_ms", "actual_cost", "actual_cold",
                "predicted_latency_ms", "completion_ms"):
        assert np.array_equal(getattr(rep.records, col),
                              getattr(res.records, col)), col


# ------------------------------------------------------- K4b and training
K4B_CASES = [  # (B, H, Hkv, S, D, causal, window)
    (2, 32, 8, 2048, 64, True, 0),       # llama3.2-1b's training attention
    (1, 16, 1, 4096, 256, True, 2048),   # recurrentgemma-9b's
    (1, 4, 2, 1000, 64, True, 0),        # ragged: S not a tile multiple
    (2, 6, 3, 77, 80, True, 24), (1, 4, 1, 45, 16, False, 0),
    (1, 2, 2, 33, 1, False, 7), (1, 4, 4, 130, 256, True, 40),
    (8, 16, 16, 781, 80, False, 0),      # hubert-xlarge's: 13 query tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K4B_CASES, ids=str)
def test_flash_attention_bwd_on_card(cuda_device, case, dtype):
    """K4b against its plain version on the card, at ``chip_smoke.py``'s
    training shapes and ragged ones, fed K4's lse as ``FlashAttentionFn``
    feeds it: float32 within K4B_F32_TOL of max(1, |grad|), bf16 each row
    within K4B_ROW_TOL of its largest |grad| (``chip_smoke.py``'s limits);
    one count per call."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_bwd_bhsd,
        flash_attention_bwd_plain,
    )

    B, H, Hkv, S, D, causal, window = case
    g = torch.Generator(device=cuda_device).manual_seed(S + D)
    q, o_like, k, v = (torch.randn(shape, generator=g, device=cuda_device)
                       .to(dtype) for shape in ((B, H, S, D), (B, H, S, D),
                                                (B, Hkv, S, D), (B, Hkv, S, D)))
    kw = dict(causal=causal, window=window)
    lse = torch.empty((B, H, S), device=cuda_device)
    o = flash_attention_bhsd(q, k, v, lse=lse, **kw)
    before = flash_attention_bwd_bhsd.launches
    got = flash_attention_bwd_bhsd(q, k, v, o, o_like, lse=lse, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, o_like, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd_bhsd.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
    if dtype == torch.float32:
        assert SMOKE.k4b_f32_err(got, want) <= SMOKE.K4B_F32_TOL, case
    else:
        assert SMOKE.k4b_row_err(got, want) <= SMOKE.K4B_ROW_TOL, case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim80_canary_on_card(cuda_device, dtype):
    """K4 and K4b at hubert-xlarge's attention ((8, 16, 781, 80), non-
    causal), which both run through their 128-wide instantiation: outputs
    written through the first 80 columns of each head of NaN-filled
    (B, S, H, 128) buffers leave the other 48 columns NaN and agree with
    the plain versions (K4b's by ``chip_smoke.py``'s limits); K4's output
    in the model's exact layout (the (B, S, H, 80) storage, strides
    (S*1280, 80, 1280, 1) as (B, H, S, D)) leaves a NaN tail past the
    view untouched and has the same bits."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_bwd_bhsd,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    B, S, H, D = 8, 781, 16, 80
    g = torch.Generator(device=cuda_device).manual_seed(D)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=cuda_device)
                   .to(dtype).transpose(1, 2) for _ in range(4))

    def canvas():
        buf = torch.full((B, S, H, 128), float("nan"), dtype=dtype,
                         device=cuda_device)
        return buf, buf[..., :D].transpose(1, 2)

    obuf, out = canvas()
    lse = torch.empty((B, H, S), device=cuda_device)
    flash_attention_bhsd(q, k, v, causal=False, out=out, lse=lse)
    n = B * S * H * D
    flat = torch.full((n + 4096,), float("nan"), dtype=dtype,
                      device=cuda_device)
    model_out = flat[:n].view(B, S, H, D).transpose(1, 2)
    assert model_out.stride() == (S * H * D, D, H * D, 1)
    flash_attention_bhsd(q, k, v, causal=False, out=model_out)
    grads = [canvas() for _ in range(3)]
    got = flash_attention_bwd_bhsd(q, k, v, out, do, causal=False, lse=lse,
                                   dq=grads[0][1], dk=grads[1][1],
                                   dv=grads[2][1])
    want = flash_attention_plain(q, k, v, causal=False)
    want_bwd = flash_attention_bwd_plain(q, k, v, out, do, causal=False)
    torch.cuda.synchronize()
    for buf, _ in [(obuf, out)] + grads:
        assert torch.isnan(buf[..., D:]).all()
        assert not torch.isnan(buf[..., :D]).any()
    assert torch.isnan(flat[n:]).all()
    assert torch.equal(model_out, out)
    assert float((out.float() - want.float()).abs().max()) <= \
        ATTN_TOL[dtype]
    if dtype == torch.float32:
        assert SMOKE.k4b_f32_err(got, want_bwd) <= SMOKE.K4B_F32_TOL
    else:
        assert SMOKE.k4b_row_err(got, want_bwd) <= SMOKE.K4B_ROW_TOL


@pytest.mark.cuda
def test_flash_attention_bwd_strided_and_deterministic_on_card(cuda_device):
    """Through ``FlashAttentionFn`` in the model's (B, S, H, D) layout (the
    kernels read and write transposed views) the gradients equal the
    kernel's on contiguous copies, and a second backward gives the same
    bits (no atomics)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_bwd_bhsd,
    )
    from repro_torch.kernels.flash_attention.ops import flash_attention

    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device)
               for shape in ((2, 300, 8, 64), (2, 300, 2, 64),
                             (2, 300, 2, 64)))
    do = torch.randn((2, 300, 8, 64), generator=g, device=cuda_device)
    runs = []
    for _ in range(2):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        flash_attention(*xs, causal=True, window=100).backward(do)
        runs.append([x.grad for x in xs])
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lse = torch.empty((2, 8, 300), device=cuda_device)
    o = flash_attention_bhsd(qt, kt, vt, causal=True, window=100, lse=lse)
    want = flash_attention_bwd_bhsd(qt, kt, vt, o, dot, causal=True,
                                    window=100, lse=lse)
    for a, b, w in zip(*runs, want):
        assert torch.equal(a, b)
        assert torch.equal(a, w.transpose(1, 2))


@pytest.mark.cuda
def test_kernels_without_a_backward_raise_under_autograd_on_card(cuda_device):
    """No gradient is dropped silently: ``loss.backward()`` through K4, K3's
    chunked regime and K6 gives the plain versions' gradients (their
    Functions' backwards are K4b, K3b and K6b, one launch each), and K5 and
    K3's fold regime (float64, and ``a=None``), which have no backward
    kernel, raise before launching. Under ``no_grad`` they launch as
    before."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_bhd,
    )
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_plain,
    )
    from repro_torch.kernels.linear_scan.kernel import linear_scan_bsd
    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_scan_bhsd,
        ssd_scan_plain,
    )

    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)

    def leaf(*shape):
        return torch.randn(shape, generator=g, device=dev).requires_grad_(True)

    q, k, v = leaf(1, 4, 40, 16), leaf(1, 2, 40, 16), leaf(1, 2, 40, 16)
    x, a = leaf(1, 8, 4), torch.rand((1, 8, 4), device=dev)
    sx, sdt = leaf(1, 2, 8, 4), torch.rand((1, 2, 8), device=dev)
    sA, sB = -torch.ones(2, device=dev), torch.randn((1, 8, 3), device=dev)
    # each call with a backward kernel: (its output under autograd, its
    # plain version's, the leaves, the forward and backward kernels)
    with_bwd = {
        "flash_attention": (
            lambda: flash_attention_bhsd(q, k, v, causal=True),
            lambda: flash_attention_plain(q, k, v, causal=True), (q, k, v),
            "flash_attention_bwd"),
        "linear_scan": (lambda: linear_scan_bsd(x, a)[0],
                        lambda: linear_scan_plain(x, a)[0], (x,),
                        "linear_scan_bwd"),
        "ssd_scan": (lambda: ssd_scan_bhsd(sx, sdt, sA, sB, sB)[0],
                     lambda: ssd_scan_plain(sx, sdt, sA, sB, sB)[0], (sx,),
                     "ssd_scan_bwd")}
    for name, (call, plain, leaves, bwd) in with_bwd.items():
        before = kernels.launch_counts()
        call().square().sum().backward()
        got = [t.grad.clone() for t in leaves]
        counts = kernels.launch_counts()
        assert counts[name] == before[name] + 1, name
        assert counts[bwd] == before[bwd] + 1, name
        for t in leaves:
            t.grad = None
        plain().square().sum().backward()
        for t_got, t in zip(got, leaves):
            torch.testing.assert_close(t_got, t.grad, rtol=1e-4, atol=1e-5)
            t.grad = None

    lengths = torch.full((1,), 5, dtype=torch.int32, device=dev)
    dq = leaf(1, 4, 1, 16)
    x64 = leaf(1, 8, 4).double()
    calls = [("decode_attention", lambda: decode_attention_bhd(
                  dq, k.detach(), v.detach(), lengths)),
             ("linear_scan", lambda: linear_scan_bsd(x64, a.double())),
             ("linear_scan", lambda: linear_scan_bsd(x))]  # a == 1
    for name, call in calls:
        n = kernels.launch_counts()[name]
        with pytest.raises(NotImplementedError, match=name):
            call()
        assert kernels.launch_counts()[name] == n  # nothing launched
        with torch.no_grad():
            call()
        assert kernels.launch_counts()[name] == n + 1


@pytest.mark.cuda
def test_flash_attention_bwd_needs_lse_on_card(cuda_device):
    """On CUDA tensors K4b takes the forward's lse or raises: there is no
    hidden recomputation of the row statistics."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_bhsd,
    )

    q = torch.ones((1, 2, 8, 16), device=cuda_device)
    before = flash_attention_bwd_bhsd.launches
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_bhsd(q, q[:, :1], q[:, :1], q, q)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_bhsd(q, q[:, :1], q[:, :1], q, q,
                                 lse=torch.zeros((1, 2, 8), device=cuda_device,
                                                 dtype=torch.float64))
    assert flash_attention_bwd_bhsd.launches == before


@pytest.mark.cuda
def test_checkpoint_recompute_relaunches_k4_on_card(cuda_device):
    """Under ``torch.utils.checkpoint`` the backward pass recomputes the
    forward through ``FlashAttentionFn`` again: K4 twice, K4b once, and the
    same gradients as without the checkpoint. A ``recording`` block around
    the step sees K4b, which autograd launches on its device thread, and,
    with the layer wrapped in ``carry_recording`` as the models wrap
    theirs, the recomputed K4 too."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.flash_attention.ops import flash_attention

    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device,
                           dtype=torch.bfloat16)
               for shape in ((1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)))

    def grads(remat):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = kernels.launch_counts()
        with kernels.recording() as rec:
            out = checkpoint(kernels.carry_recording(flash_attention), *xs,
                             use_reentrant=False) \
                if remat else flash_attention(*xs)
            out.float().square().sum().backward()
            torch.cuda.synchronize()
        tally = {name: n - before[name]
                 for name, n in kernels.launch_counts().items()
                 if n != before[name]}
        assert rec == tally
        return [x.grad for x in xs], tally

    plain, t_plain = grads(False)
    remat, t_remat = grads(True)
    assert t_plain == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert t_remat == {"flash_attention": 2, "flash_attention_bwd": 1}
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_recording_counts_k4b_per_layer_on_card(cuda_device,
                                                           remat):
    """One llama-shaped training step (the smoke llama3.2-1b in bf16) with
    its loss and ``torch.autograd.grad`` inside a ``recording()`` block
    counts K4b once per layer, though autograd launches it on its own
    device thread, and K4 once per layer more under remat "full" (the
    recompute); the block agrees with the wrappers' global counts."""
    from repro_torch.configs import smoke_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.train_loop import _value_and_grad

    cfg = smoke_config("llama3.2-1b").with_updates(remat=remat,
                                                   dtype="bfloat16")
    model = build_model(cfg)
    params = {k: t.to(cuda_device).requires_grad_(True) for k, t in
              model.init(torch.Generator().manual_seed(0)).items()}
    batch = {k: torch.as_tensor(v, device=cuda_device) for k, v in
             make_pipeline(cfg, seq_len=64, global_batch=2, seed=0)
             .batch(0).items()}
    before = kernels.launch_counts()
    with kernels.recording() as tally:
        (loss, _), grads = _value_and_grad(model, params, batch)
        torch.cuda.synchronize()
    n = cfg.n_layers
    assert tally == {"flash_attention": (2 if remat == "full" else 1) * n,
                     "flash_attention_bwd": n}
    assert tally == {name: c - before[name] for name, c in
                     kernels.launch_counts().items() if c != before[name]}
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.cuda
def test_float32_train_step_card_matches_cpu(cuda_device):
    """One float32 step of the smoke llama (remat "full") on the card and
    on the CPU from the same parameters and batch: loss and every gradient
    within 1e-4 of its scale, then the same AdamW update."""
    from repro_torch.configs import smoke_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.train_loop import _value_and_grad

    cfg = smoke_config("llama3.2-1b").with_updates(remat="full")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = {k: t.to(cuda_device).requires_grad_(True) for k, t in cpu.items()}
    for t in cpu.values():
        t.requires_grad_(True)
    batch = make_pipeline(cfg, seq_len=64, global_batch=2, seed=0).batch(0)
    kernels.reset_launch_counts()
    (loss_d, _), g_d = _value_and_grad(model, card, {
        k: torch.as_tensor(v, device=cuda_device) for k, v in batch.items()})
    (loss_c, _), g_c = _value_and_grad(
        model, cpu, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert {k: n for k, n in kernels.launch_counts().items() if n} == {
        "flash_attention": 2 * cfg.n_layers,
        "flash_attention_bwd": cfg.n_layers}
    assert abs(float(loss_d) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    for k in g_c:
        err = float((g_d[k].cpu() - g_c[k]).abs().max())
        assert err <= 1e-4 * float(g_c[k].abs().max().clamp_min(1e-30)), k
    ocfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=1)
    opt.adamw_update(card, g_d, opt.init_opt_state(card), ocfg)
    opt.adamw_update(cpu, g_c, opt.init_opt_state(cpu), ocfg)
    for k in cpu:
        # an update moves a parameter by at most ~lr (1e-3): a sign that
        # differs on a gradient at float32 noise moves it by 2 lr
        assert float((card[k].detach().cpu() - cpu[k].detach()).abs()
                     .max()) <= 2.1e-3, k


# ---------------------------------------------------------------- K3b, K6b
def _k3b_inputs(rng, B, S, D, dev):
    x, a, dh = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (
        rng.normal(size=(B, S, D)), rng.uniform(0.1, 1.0, size=(B, S, D)),
        rng.normal(size=(B, S, D))))
    dfinal = torch.as_tensor(rng.normal(size=(B, D)), dtype=torch.float32,
                             device=dev)
    h, _ = linear_scan_bsd(x, a)
    return dh, dfinal, a, h


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D", [(2, 300, 40), (1, 4096, 1024),
                                   (3, 77, 5), (1, 1, 3), (2, 257, 130)])
@pytest.mark.parametrize("with_dfinal", [True, False],
                         ids=["dfinal", "no_dfinal"])
def test_linear_scan_bwd_on_card(cuda_device, rng, B, S, D, with_dfinal):
    """K3b against its plain version: several chunks with a ragged tail,
    one chunk, one row, D not a multiple of the block; within 5e-5 of
    max(1, |grad|), and two runs bit-equal."""
    from repro_torch.kernels.linear_scan.kernel import (
        linear_scan_bwd_bsd,
        linear_scan_bwd_plain,
    )

    dh, dfinal, a, h = _k3b_inputs(rng, B, S, D, cuda_device)
    dfinal = dfinal if with_dfinal else None
    got = linear_scan_bwd_bsd(dh, dfinal, a, h)
    again = linear_scan_bwd_bsd(dh, dfinal, a, h)
    want = linear_scan_bwd_plain(dh, dfinal, a, h)
    for g, r, w in zip(got, again, want):
        assert torch.equal(g, r)
        assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= \
            SCAN_TOL


def _k6b_case(rng, b, H, S, hd, ds, chunk, dtype, dev, dstate=True):
    """K6b's inputs in the model's layout (strided views), the forward run
    with its workspace kept, and the kernel's and the plain version's
    gradients."""
    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_scan_bhsd,
        ssd_scan_bwd_bhsd,
        ssd_scan_bwd_plain,
        work_floats,
    )

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=torch.float32, device=dev).to(dt)

    x = t(rng.normal(size=(b, S, H, hd))).transpose(1, 2)
    dtt = t(rng.uniform(0.01, 0.6, size=(b, S, H)), torch.float32)\
        .transpose(1, 2)
    A = -t(rng.uniform(0.5, 3.0, size=(H,)), torch.float32)
    proj = t(rng.normal(size=(b, S, 2 * ds + 3)))
    B, C = proj[..., :ds], proj[..., ds + 1:2 * ds + 1]
    dy = t(rng.normal(size=(b, S, H, hd))).transpose(1, 2)
    dst = t(rng.normal(size=(b, H, hd, ds)), torch.float32) if dstate \
        else None
    nw = work_floats(b, H, S, hd, ds, chunk)
    work = torch.empty(nw, dtype=torch.float32, device=dev) if nw else None
    ssd_scan_bhsd(x, dtt, A, B, C, chunk=chunk, work=work)
    runs = [ssd_scan_bwd_bhsd(x, dtt, A, B, C, dy, dst, chunk=chunk,
                              work=work) for _ in range(2)]
    want = ssd_scan_bwd_plain(x, dtt, A, B, C, dy, dst, chunk=chunk)
    return runs, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,H,S,hd,ds,chunk", [
    (1, 3, 45, 8, 16, 16), (2, 5, 300, 64, 128, 128), (1, 2, 32, 64, 128, 128),
    (1, 4, 100, 64, 128, 128), (1, 9, 70, 20, 36, 32), (2, 48, 2048, 64, 128,
                                                         128)])
def test_ssd_scan_bwd_on_card(cuda_device, rng, dtype, b, H, S, hd, ds,
                              chunk):
    """K6b against its plain version: ragged chunks, mamba2-780m's widths
    over 3 chunks, the serving route's single chunk of 32, one chunked-route
    chunk of 100, odd widths, and mamba2-780m's training shape. Float32
    within 1e-4 of max(1, |grad|); bf16 each row within 2^-6 of its
    largest |grad| (``chip_smoke.py``'s limits); two runs bit-equal."""
    runs, want = _k6b_case(rng, b, H, S, hd, ds, chunk, dtype, cuda_device)
    got = runs[0]
    for g, r in zip(*runs):
        assert g.dtype == r.dtype and torch.equal(
            g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
            r.view(torch.int16) if r.dtype == torch.bfloat16 else r)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    if dtype == torch.float32:
        assert SMOKE.k4b_f32_err(got, want) <= SMOKE.K6B_TOL
    else:
        rows = lambda r: (r[0], r[1], r[2][None], r[3], r[4])  # noqa: E731
        assert SMOKE.k4b_row_err(rows(got), rows(want)) <= SMOKE.K4B_ROW_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_kernels_fall_under_their_kind_on_card(cuda_device, rng,
                                                             dtype):
    """Every kernel one K6b call launches, as ``torch.profiler`` names it,
    falls under ``chip_smoke.py``'s ``k6b`` kind (``KERNEL_KINDS``, first
    match wins), so that phase 7 files K6b's device time under K6b; the
    bf16 call launches the five tensor-core passes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_scan_bhsd,
        ssd_scan_bwd_bhsd,
        work_floats,
    )

    b, H, S, hd, ds, chunk = 1, 4, 300, 64, 128, 128
    dev = cuda_device

    def t(shape, dt=dtype):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev).to(dt)

    x, dy, B, C = t((b, H, S, hd)), t((b, H, S, hd)), t((b, S, ds)), \
        t((b, S, ds))
    dtt = torch.as_tensor(rng.uniform(0.01, 0.6, size=(b, H, S)),
                          dtype=torch.float32, device=dev)
    A = -torch.ones(H, device=dev)
    work = torch.empty(work_floats(b, H, S, hd, ds, chunk),
                       dtype=torch.float32, device=dev)
    ssd_scan_bhsd(x, dtt, A, B, C, chunk=chunk, work=work)

    def call():
        return ssd_scan_bwd_bhsd(x, dtt, A, B, C, dy, chunk=chunk, work=work)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if getattr(e, "device_time_total", 0.0) > 0}
    kinds = {name: next((k for k, frags in SMOKE.KERNEL_KINDS
                         if any(f.lower() in name.lower() for f in frags)),
                        "other") for name in names}
    # torch.empty and the wrapper's allocations launch no kernel
    assert names and set(kinds.values()) == {"k6b"}, kinds
    if dtype == torch.bfloat16:
        assert len(names) == 5, sorted(names)


@pytest.mark.cuda
def test_ssd_scan_bwd_needs_the_forward_workspace_on_card(cuda_device):
    """On CUDA tensors over more than one chunk K6b reads the states K6
    left in its workspace, and raises without it."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd_bhsd

    x = torch.ones((1, 2, 40, 8), device=cuda_device)
    dt = torch.ones((1, 2, 40), device=cuda_device)
    A = -torch.ones(2, device=cuda_device)
    B = torch.ones((1, 40, 16), device=cuda_device)
    before = ssd_scan_bwd_bhsd.launches
    with pytest.raises(ValueError, match="workspace"):
        ssd_scan_bwd_bhsd(x, dt, A, B, B, x, chunk=16)
    assert ssd_scan_bwd_bhsd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,H,S,hd,ds,chunk", [(2, 48, 2048, 64, 128, 128),
                                               (1, 3, 45, 8, 16, 16)])
def test_ssd_scan_bwd_workspace_mirrors_the_library_on_card(
        cuda_device, b, H, S, hd, ds, chunk):
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan.kernel import (
        _sm_count,
        bwd_group,
        bwd_work_floats,
    )

    fn = _build.library("ssd_scan_bwd").ssd_scan_bwd_work_floats
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_longlong
    for f32, dtype in ((1, torch.float32), (0, torch.bfloat16)):
        g = bwd_group(b, H, S, chunk, _sm_count(cuda_device), dtype)
        assert fn(b, H, S, hd, ds, min(chunk, S), g, f32) == \
            bwd_work_floats(b, H, S, hd, ds, chunk, g, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_scan_train_step_recording_counts_backward_kernels_on_card(
        cuda_device, arch, remat):
    """One smoke Mamba or Griffin training step (bf16) with its loss and
    ``torch.autograd.grad`` inside a ``recording()`` block counts K6b / K3b
    (and Griffin's K4b) once per layer, though autograd launches them on its
    own device thread, and each forward kernel once per layer more under
    remat "full" (the recompute); the block agrees with the wrappers'
    global counts, and the gradients are finite."""
    from repro_torch.configs import smoke_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.train_loop import _value_and_grad

    cfg = smoke_config(arch).with_updates(remat=remat, dtype="bfloat16")
    model = build_model(cfg)
    params = {k: t.to(cuda_device).requires_grad_(True) for k, t in
              model.init(torch.Generator().manual_seed(0)).items()}
    batch = {k: torch.as_tensor(v, device=cuda_device) for k, v in
             make_pipeline(cfg, seq_len=40, global_batch=2, seed=0)
             .batch(0).items()}
    before = kernels.launch_counts()
    with kernels.recording() as tally:
        (loss, _), grads = _value_and_grad(model, params, batch)
        torch.cuda.synchronize()
    want = SMOKE.train_launches(cfg)
    if remat == "none":
        want = {k: (n // 2 if not k.endswith("_bwd") else n)
                for k, n in want.items()}
    assert tally == want
    assert tally == {name: c - before[name] for name, c in
                     kernels.launch_counts().items() if c != before[name]}
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_scan_float32_train_step_card_matches_cpu(cuda_device, arch):
    """One float32 step of the smoke Mamba or Griffin (remat "full") on the
    card and on the CPU from the same parameters and batch: the loss and
    every gradient within 1e-4 of its scale."""
    from repro_torch.configs import smoke_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.train_loop import _value_and_grad

    cfg = smoke_config(arch).with_updates(remat="full")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = {k: t.to(cuda_device).requires_grad_(True) for k, t in cpu.items()}
    for t in cpu.values():
        t.requires_grad_(True)
    batch = make_pipeline(cfg, seq_len=40, global_batch=2, seed=0).batch(0)
    (loss_d, _), g_d = _value_and_grad(model, card, {
        k: torch.as_tensor(v, device=cuda_device) for k, v in batch.items()})
    (loss_c, _), g_c = _value_and_grad(
        model, cpu, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(float(loss_d) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    for k in g_c:
        err = float((g_d[k].cpu() - g_c[k]).abs().max())
        assert err <= 1e-4 * float(g_c[k].abs().max().clamp_min(1e-30)), k


# ------------------------------------------------------- the audio encoder
@pytest.mark.cuda
def test_encoder_float32_forward_and_train_step_card_matches_cpu(
        cuda_device):
    """The smoke hubert-xlarge at head_dim 80 (2 heads, the full model's
    head width), float32, remat "full", on the card and on the CPU from the
    same parameters and a masked frames batch: the encode logits within
    1e-4 (K4 once a layer), then one step's loss and every gradient within
    1e-4 of its scale, with K4 twice a layer and K4b once."""
    from repro_torch.configs import smoke_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.train_loop import _value_and_grad

    cfg = smoke_config("hubert-xlarge").with_updates(
        remat="full", head_dim=80, n_heads=2, n_kv_heads=2)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = {k: t.to(cuda_device) for k, t in cpu.items()}
    batch = make_pipeline(cfg, seq_len=100, global_batch=2,
                          seed=0).batch(0)
    assert batch["mask"].any()
    b_d = {k: torch.as_tensor(v, device=cuda_device)
           for k, v in batch.items()}
    b_c = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad(), kernels.recording() as tally:
        got = model.encode(card, b_d)
        torch.cuda.synchronize()
    assert tally == {"flash_attention": cfg.n_layers}
    with torch.no_grad():
        want = model.encode(cpu, b_c)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    for p in list(card.values()) + list(cpu.values()):
        p.requires_grad_(True)
    with kernels.recording() as tally:
        (loss_d, _), g_d = _value_and_grad(model, card, b_d)
        torch.cuda.synchronize()
    assert tally == {"flash_attention": 2 * cfg.n_layers,
                     "flash_attention_bwd": cfg.n_layers}
    (loss_c, _), g_c = _value_and_grad(model, cpu, b_c)
    assert abs(float(loss_d) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    for k in g_c:
        err = float((g_d[k].cpu() - g_c[k]).abs().max())
        assert err <= 1e-4 * float(g_c[k].abs().max().clamp_min(1e-30)), k


# ------------------------------- the MoE, grouped and int8-cache decoders
def _decoder_variant(name, **upd):
    """The smoke configs of the decoder's variants: olmoe-1b-7b's MoE
    layers, its grouped ``moe_every=2`` layout at 4 layers (a dataclass
    subclass adds the field ``LM`` reads with ``getattr``) and llama's int8
    KV cache."""
    import dataclasses

    from repro_torch.configs import ArchConfig, smoke_config

    @dataclasses.dataclass(frozen=True)
    class Grouped(ArchConfig):
        moe_every: int = 1

    if name == "olmoe":
        return smoke_config("olmoe-1b-7b").with_updates(**upd)
    if name == "grouped":
        cfg = smoke_config("olmoe-1b-7b").with_updates(n_layers=4)
        return Grouped(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)},
                       moe_every=2).with_updates(**upd)
    return smoke_config("llama3.2-1b").with_updates(kv_quant=True, **upd)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["olmoe", "grouped", "kv_quant"])
def test_decoder_variants_card_match_cpu(cuda_device, name):
    """Float32 on the card (K4, K5, cuBLAS) against the same weights on
    the CPU: a (2, 12) prefill and 4 decode steps past the cache, logits
    and caches within 1e-4 (the int8 cache's values off by one only where
    a value sits on a rounding boundary; each of its steps from the CPU's
    cache), and a float32 training step's
    loss and gradients within 1e-4 of their scale."""
    from repro_torch.modeling.registry import build_model
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.train_loop import _value_and_grad

    cfg = _decoder_variant(name, remat="full")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = {k: t.to(cuda_device) for k, t in cpu.items()}
    toks = torch.arange(24, dtype=torch.int32).reshape(2, 12) * 5 % cfg.vocab
    lg, cg = model.prefill(card, {"tokens": toks.to(cuda_device)})
    lc, cc = model.prefill(cpu, {"tokens": toks})
    for step in range(5):
        assert (lg.cpu() - lc).abs().max().item() < 1e-4, step
        for k in cc:
            got, want = cg[k].cpu(), cc[k]
            assert got.dtype == want.dtype, k
            if want.dtype == torch.int8:
                d = (got.int() - want.int()).abs()
                assert d.max() <= 1 and d.count_nonzero() <= 0.005 * d.numel()
            else:
                assert (got.double() - want.double()).abs().max() < 1e-4, k
        if cfg.kv_quant:  # each step from the CPU's cache: a value that
            # rounds the other way would move every later step
            cg = {k: v.to(cuda_device, copy=True) for k, v in cc.items()}
        tok = torch.tensor([step, 3 * step + 1], dtype=torch.int32)
        lg, cg = model.decode_step(card, cg, {"token": tok.to(cuda_device)})
        lc, cc = model.decode_step(cpu, cc, {"token": tok})
    batch = make_pipeline(cfg, seq_len=32, global_batch=2, seed=0).batch(0)
    for t in (*cpu.values(), *card.values()):
        t.requires_grad_(True)
    (loss_d, met_d), g_d = _value_and_grad(model, card, {
        k: torch.as_tensor(v, device=cuda_device) for k, v in batch.items()})
    (loss_c, met_c), g_c = _value_and_grad(
        model, cpu, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(float(loss_d) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    assert abs(float(met_d["aux"]) - float(met_c["aux"])) <= 1e-4
    for k in g_c:
        err = float((g_d[k].cpu() - g_c[k]).abs().max())
        assert err <= 1e-4 * max(float(g_c[k].abs().max()), 1.0), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["olmoe", "grouped", "kv_quant"])
def test_decoder_variants_graphs_bit_equal_to_eager_on_card(cuda_device,
                                                            name):
    """In bf16 as an executor serves them: the prefill replayed from its
    CUDA graph (two prompts) and 6 decode steps replayed from theirs (past
    the cache), each bit-equal to the eager step, logits and every cache
    tensor (the int8 cache's scales included); the graphs replay K4 and K5
    once per layer."""
    from repro_torch.serving.engine import (
        DecodeGraph,
        PrefillGraph,
        make_compiled_steps,
        replayed_launches,
        reset_replayed_launches,
    )

    cfg = _decoder_variant(name, dtype="bfloat16")
    model, params, prefill_fn, decode_fn = make_compiled_steps(
        cfg, seed=0, device=cuda_device)
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab, (2, 12), generator=gen,
                             dtype=torch.int32).to(cuda_device)
               for _ in range(2)]
    pgraph = PrefillGraph(prefill_fn, params, prompts[0])
    assert pgraph.launches_per_replay == {"flash_attention": cfg.n_layers}
    reset_replayed_launches()
    for tokens in prompts:
        pgraph.tokens.copy_(tokens)
        logits, cache = pgraph.run()
        e_logits, e_cache = prefill_fn(params, {"tokens": tokens})
        assert torch.equal(logits, e_logits)
        assert set(cache) == set(e_cache)
        for k in e_cache:
            assert torch.equal(cache[k], e_cache[k]), k
    dgraph = DecodeGraph(decode_fn, params, e_cache)
    assert dgraph.launches_per_replay == {"decode_attention": cfg.n_layers}
    dgraph.load(e_cache)
    eager = {k: v.clone() for k, v in e_cache.items()}
    for step in range(6):
        dgraph.token.fill_(step)
        got = dgraph.step().clone()
        want, eager = decode_fn(params, eager, {"token": torch.full(
            (2,), step, dtype=torch.int32, device=cuda_device)})
        assert torch.equal(got, want), step
    for k in eager:
        assert torch.equal(dgraph.cache[k], eager[k]), k
    assert replayed_launches() == {"flash_attention": 2 * cfg.n_layers,
                                   "decode_attention": 6 * cfg.n_layers}


@pytest.mark.cuda
def test_moe_train_step_recording_counts_k4_and_k4b_on_card(cuda_device):
    """One bf16 training step of the smoke olmoe-1b-7b (remat "full") with
    its loss and ``torch.autograd.grad`` inside a ``recording()`` block:
    K4 twice a layer (forward and recompute), K4b once; loss, aux loss and
    gradients finite, the router's gradient float32 and nonzero."""
    from repro_torch.modeling.registry import build_model
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.train_loop import _value_and_grad

    cfg = _decoder_variant("olmoe", dtype="bfloat16", remat="full")
    model = build_model(cfg)
    params = {k: t.to(cuda_device).requires_grad_(True) for k, t in
              model.init(torch.Generator().manual_seed(0)).items()}
    batch = {k: torch.as_tensor(v, device=cuda_device) for k, v in
             make_pipeline(cfg, seq_len=64, global_batch=2, seed=0)
             .batch(0).items()}
    with kernels.recording() as tally:
        (loss, met), grads = _value_and_grad(model, params, batch)
        torch.cuda.synchronize()
    n = cfg.n_layers
    assert tally == {"flash_attention": 2 * n, "flash_attention_bwd": n}
    assert torch.isfinite(loss) and float(met["aux"]) > 0
    assert all(torch.isfinite(g).all() for g in grads.values())
    router = grads["layers/moe/router/w"]
    assert router.dtype == torch.float32 and bool(router.any())


@pytest.fixture
def card_mesh(cuda_device):
    """The host mesh on the card (a one-process group), torn down after
    the test."""
    from repro_torch.launch.mesh import destroy_group, make_host_mesh

    try:
        yield make_host_mesh()
    finally:
        destroy_group()


@pytest.mark.cuda
def test_shard_under_one_card_context_on_card(card_mesh):
    """On the card's (1, 1) host mesh ``shard`` returns a plain CUDA tensor
    itself and redistributes a DTensor, and a kernel refuses a DTensor."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import make_rules, shard, sharding_ctx
    from repro_torch.kernels import _build

    rules = make_rules(smoke_config("llama3.2-1b"), card_mesh)
    x = torch.randn(2, 8, 64, device="cuda")
    d = distribute_tensor(x, card_mesh, (Replicate(), Replicate()),
                          src_data_rank=None)
    with sharding_ctx(card_mesh, rules):
        assert shard(x, ("batch", None, "mlp_act")) is x
        y = shard(d, ("batch", None, "mlp_act"))
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert y.to_local().is_cuda and torch.equal(y.full_tensor(), x)
    with pytest.raises(TypeError, match="DTensor"):
        _build.ptr(y)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    t = tree.detach().to(device)
    return t.requires_grad_(tree.requires_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cell_materializes_and_steps_on_card(card_mesh, kind):
    """A smoke-size llama3.2-1b cell (float32) materialized on the card and
    stepped under its sharding context launches its kernels (K4 and K4b,
    K4, K5) and matches the same step on CPU copies of its arguments."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.launch.steps import build_cell, materialize

    cfg = smoke_config("llama3.2-1b")
    cell = build_cell(cfg, ShapeConfig("tiny", 64, 2, kind), card_mesh)
    args = materialize(cell, global_batch=2)
    cpu_args = tuple(_to(a, "cpu") for a in args)
    with kernels.recording() as tally, sharding_ctx(card_mesh, cell.rules):
        got = cell.step(*args)
        torch.cuda.synchronize()
    want = cell.step(*cpu_args)
    n = cfg.n_layers
    expect = {"train": {"flash_attention": n, "flash_attention_bwd": n},
              "prefill": {"flash_attention": n},
              "decode": {"decode_attention": n}}[kind]
    assert tally == expect
    if kind == "train":
        pairs = [(got[2]["loss"], want[2]["loss"])]
        pairs += [(got[0][k], want[0][k]) for k in want[0]]
    else:
        pairs = [(got[0], want[0])] + [(got[1][k], want[1][k])
                                       for k in want[1]]
    for g, w in pairs:
        np.testing.assert_allclose(g.detach().cpu().float().numpy(),
                                   w.detach().float().numpy(), rtol=1e-4,
                                   atol=1e-4)
