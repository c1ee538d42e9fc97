"""The port's kernels (``repro_torch.kernels``) against the JAX package.

On the CPU every wrapper runs its kernel's plain PyTorch version, which is
what these tests hold against the reference: the JAX package's numpy
oracles (``ref.py``), its Pallas kernels run with ``interpret=True`` (as
``tests/test_kernels.py`` runs them) and ``repro.core.gbrt.GBRT.predict``.
Inputs come from numpy seeds and both packages see the same arrays.

Tolerances: float32 GBRT 1e-4 and float32 linear scan 5e-5 (the reference's
own kernel tolerances — float32 sums in another order or with FMAs);
float64 results must be bit-equal (the same rounded operations in the same
order). The state replay has no JAX counterpart that runs here (the JAX
core's scan sits behind its broken x64 scope), so its plain version is held
to the port's scalar oracle below and, end to end, by
``tests/test_torch_core.py``'s per-record parity.

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
    gbrt_predict_blocked_plain,
    gbrt_predict_multi_plain,
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
from repro_torch.kernels.linear_scan.ops import linear_scan, prefix_sum
from repro_torch.kernels.linear_scan.ref import linear_scan_ref as np_scan_ref
from repro_torch.kernels.state_replay.kernel import (
    state_replay,
    state_replay_plain,
)
from repro_torch.kernels.state_replay.ref import state_replay_ref
from test_torch_cuda import replay_inputs, to_torch

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
    x = rng.normal(size=(400, n_features)) * 100.0
    y = x[:, 0] * 2.0 + np.sin(x[:, -1] / 30.0) * 10.0 + rng.normal(size=400)
    return RefGBRT.fit(x, y, RefGBRTConfig(n_trees=n_trees, max_depth=depth))


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
