"""The port's kernels (``repro_torch.kernels``) against the JAX package.

On the CPU every wrapper runs its kernel's plain PyTorch version, which is
what these tests hold against the reference: the JAX package's numpy
oracles (``ref.py``), its Pallas kernels run with ``interpret=True`` (as
``tests/test_kernels.py`` runs them) and ``repro.core.gbrt.GBRT.predict``.
Inputs come from numpy seeds and both packages see the same arrays.

Tolerances: float32 GBRT 1e-4 and float32 linear scan 5e-5 (the reference's
own kernel tolerances — float32 sums in another order or with FMAs);
float64 results must be bit-equal (the same rounded operations in the same
order), and so must the GBRT kernels' step-table method
(``gbrt_step_table_ref``) and their plain walks in float32 too. The state
replay has no JAX counterpart that runs here (the JAX core's scan sits
behind its broken x64 scope), so its plain version is held to the port's
scalar oracle below and, end to end, by ``tests/test_torch_core.py``'s
per-record parity.

The CUDA kernels themselves are held against these plain versions on a
card by ``tests/test_torch_cuda.py`` (marker ``cuda``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gbrt import GBRT as RefGBRT
from repro.core.gbrt import GBRTConfig as RefGBRTConfig
from repro.kernels.gbrt_predict.kernel import gbrt_predict_multi as pallas_multi
from repro.kernels.gbrt_predict.ops import gbrt_predict as pallas_gbrt
from repro.kernels.gbrt_predict.ops import multi_kernel_operands as pallas_ops
from repro.kernels.gbrt_predict.ref import gbrt_predict_ref
from repro.kernels.linear_scan.ops import linear_scan as pallas_scan
from repro.kernels.linear_scan.ref import linear_scan_ref
from repro_torch.core.gbrt import GBRT, GBRTConfig
from repro_torch.kernels.gbrt_predict.kernel import (
    TABLE_CELLS,
    StepTable,
    blocked_route,
    gbrt_predict_blocked_plain,
    gbrt_predict_multi_plain,
    record_step_table,
    step_table,
)
from repro_torch.kernels.gbrt_predict.ops import (
    gbrt_predict,
    gbrt_predict_configs,
    kernel_operands,
    multi_kernel_operands,
)
from repro_torch.kernels.gbrt_predict.ref import (
    gbrt_predict_ref as port_gbrt_ref,
)
from repro_torch.kernels.gbrt_predict.ref import gbrt_step_table_ref
from repro_torch.kernels.linear_scan.ops import linear_scan, prefix_sum
from repro_torch.kernels.linear_scan.ref import linear_scan_ref as np_scan_ref
from repro_torch.kernels.state_replay.kernel import (
    state_replay,
    state_replay_plain,
)
from repro_torch.kernels.state_replay.ref import state_replay_ref
from test_torch_cuda import (
    SMOKE,
    gbrt_adversarial,
    gbrt_data,
    replay_inputs,
    to_torch,
)

GBRT_TOL = 1e-4
SCAN_TOL = 5e-5


def _port_gbrt(m) -> GBRT:
    """The reference model's parameters, carried over as numpy arrays."""
    c = m.config
    return GBRT(config=GBRTConfig(n_trees=c.n_trees, max_depth=c.max_depth,
                                  learning_rate=c.learning_rate),
                base=float(m.base), features=np.array(m.features),
                thresholds=np.array(m.thresholds),
                leaves=np.array(m.leaves))


def _fit(rng, n_features, depth, n_trees):
    """A reference ensemble whose trees test every one of its features."""
    return RefGBRT.fit(*gbrt_data(rng, n_features),
                       RefGBRTConfig(n_trees=n_trees, max_depth=depth))


# ------------------------------------------------------------------- K2
@pytest.mark.parametrize("n_features,depth,n_trees",
                         [(1, 2, 20), (2, 3, 50), (3, 4, 10)])
def test_gbrt_blocked_plain_matches_reference(n_features, depth, n_trees, rng):
    ref_m = _fit(rng, n_features, depth, n_trees)
    m = _port_gbrt(ref_m)
    xq = rng.normal(size=(137, n_features)) * 100.0
    # float32: the TPU kernel's contract, against the numpy oracle and the
    # Pallas kernel in interpret mode
    p32 = gbrt_predict(m, torch.as_tensor(xq, dtype=torch.float32)).numpy()
    oracle = gbrt_predict_ref(xq.astype(np.float32), ref_m.features,
                              ref_m.thresholds, ref_m.leaves, depth=depth,
                              lr=ref_m.config.learning_rate, base=ref_m.base)
    np.testing.assert_allclose(p32, oracle, rtol=GBRT_TOL, atol=GBRT_TOL)
    np.testing.assert_allclose(p32, pallas_gbrt(ref_m, xq, block_n=64),
                               rtol=GBRT_TOL, atol=GBRT_TOL)
    # float64: bit-equal to the reference's numpy walk, to the port's own
    # oracle and to the port's tensor walk
    p64 = gbrt_predict(m, torch.as_tensor(xq)).numpy()
    assert np.array_equal(p64, ref_m.predict(xq))
    assert np.array_equal(p64, port_gbrt_ref(
        xq, m.features, m.thresholds, m.leaves, depth=depth,
        lr=m.config.learning_rate, base=m.base))
    assert np.array_equal(m.predict_torch(torch.as_tensor(xq)).numpy(), p64)


# ------------------------------------------------------------------- K1
def test_gbrt_multi_plain_matches_reference(rng):
    """Heterogeneous depths / tree counts and a repeated model: every
    column equals the per-config prediction."""
    ref_models = [_fit(rng, 2, d, t) for d, t in [(2, 20), (3, 50), (4, 10)]]
    ref_models.append(ref_models[0])
    mems = [1280.0, 1536.0, 1792.0, 2048.0]
    sizes = rng.normal(size=(256,)) * 100.0
    models = [_port_gbrt(m) for m in ref_models]
    models[3] = models[0]
    mem = torch.tensor(mems, dtype=torch.float64)
    p64 = gbrt_predict_configs(models, mem, torch.as_tensor(sizes)).numpy()
    p32 = gbrt_predict_configs(models, mem, torch.as_tensor(
        sizes, dtype=torch.float32)).numpy()
    F, TH, LV, LR, BASE, dmax = pallas_ops(ref_models)
    mem32 = jnp.asarray(np.array([[m] for m in mems], np.float32))
    pallas = np.asarray(pallas_multi(
        jnp.asarray(sizes.astype(np.float32)[:, None]), mem32, LR, BASE, F,
        TH, LV, depth=dmax, block_n=64, interpret=True))
    assert p64.shape == p32.shape == (256, 4)
    np.testing.assert_allclose(p32, pallas, rtol=GBRT_TOL, atol=GBRT_TOL)
    for c, (m, mem) in enumerate(zip(ref_models, mems)):
        x2 = np.stack([sizes, np.full(256, mem)], axis=1)
        assert np.array_equal(p64[:, c], m.predict(x2)), f"config {c}"


def test_gbrt_multi_equals_blocked_per_config(rng):
    """The stacked multi-config operands (pass-through padding, leaf remap)
    reproduce the per-config blocked walk bit for bit in float64."""
    models = [_port_gbrt(_fit(rng, 2, d, t)) for d, t in [(2, 7), (4, 12)]]
    sizes = torch.as_tensor(rng.uniform(-200, 200, size=64))
    F, TH, LV, LR, BASE, depth = multi_kernel_operands(models)
    mem = torch.tensor([1536.0, 2048.0], dtype=torch.float64)
    multi = gbrt_predict_multi_plain(sizes, mem, LR, BASE, F, TH, LV,
                                     depth=depth)
    for c, m in enumerate(models):
        feats, thr, lvs = kernel_operands(m)
        x2 = torch.stack([sizes, torch.full_like(sizes, float(mem[c]))], 1)
        single = gbrt_predict_blocked_plain(
            x2, feats, thr, lvs, depth=m.config.max_depth,
            lr=m.config.learning_rate, base=m.base)
        assert torch.equal(multi[:, c], single)
    assert kernel_operands(models[0]) is kernel_operands(models[0])


# ------------------------------------------------------- K1/K2 step tables
def _npd(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_features,depth,n_trees",
                         [(1, 2, 20), (2, 3, 50), (3, 4, 10)])
def test_gbrt_step_table_ref_is_the_blocked_walk(n_features, depth, n_trees,
                                                 dtype, rng):
    """K2's table method, on rows at every break, its float neighbours,
    NaN, +-inf and +-0.0: bit-equal to the plain walk in both dtypes, to
    the reference's ``GBRT.predict`` in float64, and within 1e-4 of the
    Pallas kernel (interpret mode) in float32 on the finite rows (the TPU
    kernel selects a feature by a one-hot product, so a non-finite value
    in any column turns every compare of its row into NaN's)."""
    ref_m = _fit(rng, n_features, depth, n_trees)
    m = _port_gbrt(ref_m)
    feats, thr, lvs = kernel_operands(m, dtype)
    br, counts = step_table(thr).breaks, step_table(thr).counts
    assert len(counts) == n_features
    x = torch.as_tensor(np.stack(
        [gbrt_adversarial(br[f].numpy(), rng, _npd(dtype), 600)
         for f in range(n_features)], 1))
    kw = dict(depth=depth, lr=m.config.learning_rate, base=m.base)
    walk = gbrt_predict_blocked_plain(x, feats, thr, lvs, **kw)
    table = gbrt_step_table_ref(
        x, br, counts,
        lambda p: gbrt_predict_blocked_plain(p, feats, thr, lvs, **kw))
    assert SMOKE.bits_equal(table, walk)
    if dtype == torch.float64:
        assert SMOKE.bits_equal(
            table, torch.as_tensor(ref_m.predict(x.numpy())))
    else:
        finite = torch.isfinite(x).all(1)
        np.testing.assert_allclose(
            table[finite].numpy(),
            pallas_gbrt(ref_m, x[finite].numpy(), block_n=64),
            rtol=GBRT_TOL, atol=GBRT_TOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gbrt_step_table_ref_is_the_multi_walk(dtype, rng):
    """K1's table method per config (depths 2-4 padded to one stack and a
    repeated model) on sizes at every config's break, its neighbours, NaN,
    +-inf and +-0.0: bit-equal to the plain walk, in float64 to the
    reference's ``GBRT.predict`` at (size, mem), and in float32 within 1e-4
    of the Pallas kernel (interpret mode) on the finite sizes."""
    ref_models = [_fit(rng, 2, d, t) for d, t in [(2, 20), (3, 50),
                                                      (4, 10)]]
    ref_models.append(ref_models[0])
    models = [_port_gbrt(m) for m in ref_models]
    models[3] = models[0]
    mems = [1280.0, 1536.0, 1792.0, 2048.0]
    F, TH, LV, LR, BASE, depth = multi_kernel_operands(models, dtype)
    BR, counts = step_table(TH).breaks, step_table(TH).counts
    sizes = torch.as_tensor(np.concatenate(
        [gbrt_adversarial(BR[c].numpy(), rng, _npd(dtype), 300)
         for c in range(4)]))
    mem = torch.tensor(mems, dtype=dtype)
    walk = gbrt_predict_multi_plain(sizes, mem, LR, BASE, F, TH, LV,
                                    depth=depth)
    for c in range(4):
        table = gbrt_step_table_ref(
            sizes[:, None], BR[c:c + 1], counts[c:c + 1],
            lambda p: gbrt_predict_multi_plain(
                p[:, 0].contiguous(), mem, LR, BASE, F, TH, LV,
                depth=depth)[:, c])
        assert SMOKE.bits_equal(table, walk[:, c]), f"config {c}"
        if dtype == torch.float64:
            x2 = np.stack([sizes.numpy(), np.full(len(sizes), mems[c])], 1)
            assert SMOKE.bits_equal(table, torch.as_tensor(
                ref_models[c].predict(x2))), f"config {c}"
    if dtype == torch.float32:
        finite = torch.isfinite(sizes)
        s = sizes[finite].numpy()
        s = np.pad(s, (0, (-len(s)) % 64))
        Fp, THp, LVp, LRp, BASEp, dmax = pallas_ops(ref_models)
        pallas = np.asarray(pallas_multi(
            jnp.asarray(s[:, None]),
            jnp.asarray(np.array([[m] for m in mems], np.float32)), LRp,
            BASEp, Fp, THp, LVp, depth=dmax, block_n=64, interpret=True))
        np.testing.assert_allclose(walk[finite].numpy(),
                                   pallas[:int(finite.sum())],
                                   rtol=GBRT_TOL, atol=GBRT_TOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gbrt_breaks_operands(dtype, rng):
    """The breaks beside the ensemble operands: per feature (K2) and per
    config (K1) the sorted distinct thresholds in the operand dtype, NaN
    and +inf left out, +inf padded, with their counts; float32 ones after
    the +-3e38 clip, where two float64 thresholds may merge."""
    m = _port_gbrt(_fit(rng, 2, 3, 30))
    th = np.array(m.thresholds)
    th[0, 0] = np.nan                   # sends every row left
    th[1, 0] = -np.inf                  # a real break (-3e38 in float32)
    th[2, :2] = [4096.0, np.nextafter(4096.0, np.inf)]  # one float32 value
    th[3, 0] = 1e39                     # 3e38 in float32
    m.thresholds = th
    feats = np.array(m.features)
    feats[1, 0] = feats[2, 0] = feats[2, 1] = feats[3, 0] = 0
    m.features = feats
    _, thr, _ = kernel_operands(m, dtype)
    br, counts = step_table(thr).breaks, step_table(thr).counts
    npd = _npd(dtype)
    for f, n in enumerate(counts):
        want = thr.numpy()[feats == f]
        want = np.unique(want[~np.isnan(want) & (want != np.inf)])
        assert n == len(want) and br.dtype == dtype
        assert np.array_equal(br[f, :n].numpy(), want.astype(npd))
        assert (br[f, n:] == np.inf).all()
    assert br.shape == (2, max(counts) + 1)
    lo, hi = (-np.inf, 1e39) if dtype == torch.float64 else (-3e38, 3e38)
    assert br[0, 0] == npd(lo) and npd(hi) in br[0].numpy()
    f64 = step_table(kernel_operands(m)[1]).counts
    if dtype == torch.float32:
        assert counts[0] == f64[0] - 1     # the two 4096s merged
    models = (m, _port_gbrt(_fit(rng, 2, 2, 10)))
    F, TH, *_ = multi_kernel_operands(models, dtype)
    BR, mcounts = step_table(TH).breaks, step_table(TH).counts
    for c in range(2):
        want = TH[c].numpy()[F[c].numpy() == 0]
        want = np.unique(want[~np.isnan(want) & (want != np.inf)])
        assert mcounts[c] == len(want)
        assert np.array_equal(BR[c, :len(want)].numpy(), want)
        assert (BR[c, len(want):] == np.inf).all()
    assert BR.shape == (2, max(mcounts) + 1)


def test_gbrt_breaks_cached_by_model_identity(rng):
    """The step tables ride on the operand caches' thresholds tensors: one
    model, one entry (per dtype); a refit (a fresh model object, the same
    arrays) misses it and records its own; a tensor without one, or changed
    in place since, is refused."""
    m = _port_gbrt(_fit(rng, 2, 3, 20))
    ops = kernel_operands(m)
    assert kernel_operands(m) is ops
    assert kernel_operands(m, torch.float32) is not ops
    multi = multi_kernel_operands((m, m))
    assert multi_kernel_operands((m, m)) is multi
    refit = _port_gbrt(_fit(np.random.default_rng(0), 2, 3, 20))
    assert kernel_operands(refit) is not ops
    assert multi_kernel_operands((m, refit)) is not multi
    tab = step_table(kernel_operands(refit)[1])
    assert tab is not step_table(ops[1])
    assert SMOKE.bits_equal(tab.breaks, step_table(ops[1]).breaks)
    thr = ops[1].clone()
    with pytest.raises(ValueError, match="no step table"):
        step_table(thr)
    record_step_table(thr, tab.breaks, tab.counts)
    assert step_table(thr).counts == tab.counts
    thr.add_(0.0)
    with pytest.raises(ValueError, match="no step table"):
        step_table(thr)


def test_gbrt_blocked_plain_rejects_feature_ids_past_f(rng):
    """A model that tests a feature id at or past F is refused with a
    ValueError, as the reference's numpy walk refuses it (IndexError)."""
    ref_m = _fit(rng, 2, 3, 20)
    m = _port_gbrt(ref_m)
    feats, thr, lvs = kernel_operands(m)
    x = torch.as_tensor(rng.normal(size=(200, 1)) * 100.0)
    kw = dict(depth=3, lr=m.config.learning_rate, base=m.base)
    with pytest.raises(ValueError, match="past x's 1 columns"):
        gbrt_predict_blocked_plain(x, feats, thr, lvs, **kw)
    with pytest.raises(ValueError, match="past x's 1 columns"):
        gbrt_predict(m, x)
    with pytest.raises(IndexError):
        ref_m.predict(x.numpy())


@pytest.mark.parametrize("counts,route", [
    ((59, 3), "table"), ((7, 7, 7), "table"),
    ((TABLE_CELLS - 1,), "table"), ((TABLE_CELLS,), "walk"),
    ((60, 60, 60, 60), "walk"), ((63, 63), "table"),
    ((1,) * 17, "walk"), ((0,) * 16, "table")])
def test_gbrt_blocked_route(counts, route):
    """K2's route from the model's sizes alone: the table while its cells
    fit and at most 16 feature ids exist; otherwise the walk."""
    assert blocked_route(counts) == route
    assert StepTable(torch.zeros((len(counts), 1)), counts).route == route


# ------------------------------------------------------------------- K3
@pytest.mark.parametrize("B,S,D", [(1, 16, 8), (2, 64, 32), (1, 100, 16),
                                   (3, 7, 4)])
def test_linear_scan_plain_matches_reference(B, S, D, rng):
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    a = rng.uniform(0.1, 1.0, size=(B, S, D)).astype(np.float32)
    y, st = linear_scan(torch.as_tensor(x), torch.as_tensor(a))
    yr, sr = linear_scan_ref(jnp.asarray(x), jnp.asarray(a))
    yp, sp = pallas_scan(jnp.asarray(x), jnp.asarray(a), chunk=8)
    for ref_y, ref_s in ((yr, sr), (yp, sp)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(ref_s),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
    # float64: the sequential fold, bit for bit
    y64, s64 = linear_scan(torch.as_tensor(x.astype(np.float64)),
                           torch.as_tensor(a.astype(np.float64)))
    ny, ns = np_scan_ref(x.astype(np.float64), a.astype(np.float64))
    assert np.array_equal(y64.numpy(), ny) and np.array_equal(s64.numpy(), ns)


@pytest.mark.parametrize("n", [1, 2, 513, 4097])
def test_prefix_sum_is_the_sequential_fold(n, rng):
    """The surplus-bank prefix: float64 bit-equal to a left fold (and so to
    the oracle's ``np.cumsum``), including the surplus seed in front."""
    x = rng.normal(size=n) * 1e-6
    x[0] = 3.7e-5
    got = prefix_sum(torch.as_tensor(x)).numpy()
    acc, fold = 0.0, []
    for v in x.tolist():
        acc = acc + v
        fold.append(acc)
    assert np.array_equal(got, np.array(fold))
    assert np.array_equal(got, np.cumsum(x))


@pytest.mark.parametrize("shape", [(1, 65_537, 1), (2, 4096, 1024),
                                   (2, 300, 40), (1, 1, 1), (3, 0, 5)])
def test_linear_scan_regime_route(shape):
    """The CUDA wrapper's route: float64, or no gate, takes the exact fold;
    a gated float32 scan the chunked scan; the same for every shape, so a
    stream's numbers never depend on its chunk size."""
    from repro_torch.kernels.linear_scan.kernel import scan_regime

    for dtype in (torch.float32, torch.float64):
        x = torch.zeros(shape, dtype=dtype)
        assert scan_regime(x, None) == "fold"
        want = "chunked" if dtype == torch.float32 else "fold"
        assert scan_regime(x, torch.ones_like(x)) == want


# ------------------------------------------------------------- replay
@pytest.mark.parametrize("nd,nc,cap,lpw,fill", [
    (3, 4, 64, True, 20),      # the slice's shape: LPW fleet, 4 configs
    (3, 3, 16, False, 6),      # fixed nominations
    (1, 2, 8, False, 8),       # one device; full pools -> overflow flags
    (0, 3, 32, False, 10),     # cloud only
    (2, 0, 0, True, 0),        # edge only
], ids=["lpw", "fixed", "overflow", "cloud_only", "edge_only"])
def test_state_replay_plain_matches_scalar_oracle(nd, nc, cap, lpw, fill,
                                                  rng):
    nows, guess, kw = replay_inputs(rng, 300, nd, nc, cap, lpw, fill)
    got = state_replay_plain(*to_torch(nows, guess, kw)[:2],
                             **to_torch(nows, guess, kw)[2])
    ref = state_replay_ref(nows, guess, **kw)
    assert np.array_equal(got.hb.numpy(), ref["hb"])
    assert np.array_equal(got.h_fin.numpy(), ref["h_fin"])
    if nd:
        assert np.array_equal(got.nom.numpy(), ref["nom"])
    assert np.array_equal(got.cold.numpy(), ref["cold"])
    assert np.array_equal(got.cnt.numpy(), ref["cnt"])
    assert np.array_equal(got.overflow.numpy(), ref["overflow"])
    assert np.array_equal(got.busy.numpy(), ref["busy"])
    assert np.array_equal(got.last.numpy(), ref["last"])
    if nc and fill >= cap:
        assert ref["overflow"].any()


def test_state_replay_wrapper_reuses_out_buffers(rng):
    nows, guess, kw = replay_inputs(rng, 40, 2, 2, 16, True, 4)
    tn, tg, tkw = to_torch(nows, guess, kw)
    out = (torch.empty((2, 16), dtype=torch.float64),
           torch.empty((2, 16), dtype=torch.float64),
           torch.empty(2, dtype=torch.int32))
    got = state_replay(tn, tg, out=out, **tkw)
    assert got.busy is out[0] and got.last is out[1] and got.cnt is out[2]
    ref = state_replay_plain(tn, tg, **tkw)
    assert torch.equal(got.busy, ref.busy) and torch.equal(got.cnt, ref.cnt)


def test_operands_built_once_under_concurrent_threads(monkeypatch):
    """Shards in threads ask for one model's operands at once: the build
    runs under the operand lock, so every thread gets the one operand set
    and its step table (``_STEP_TABLES`` is written under the lock)."""
    import threading

    from repro_torch.kernels.gbrt_predict import ops
    from repro_torch.kernels.gbrt_predict.kernel import step_table

    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 2))
    models = [GBRT.fit(x, x[:, 0] * k, GBRTConfig(n_trees=20, max_depth=3))
              for k in (1.0, 2.0)]
    builds = []
    breaks = ops.step_breaks

    def slow_breaks(*args, **kwargs):
        builds.append(1)
        threading.Event().wait(0.01)  # a thread switch inside the build
        return breaks(*args, **kwargs)

    monkeypatch.setattr(ops, "step_breaks", slow_breaks)
    start = threading.Barrier(8)
    out = [None] * 8

    def ask(i):
        start.wait()
        out[i] = ops.multi_kernel_operands(models)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1
    assert all(o is out[0] for o in out)
    assert step_table(out[0][1]).counts
