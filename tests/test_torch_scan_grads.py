"""The backward of the port's two scans against the JAX package's, on the
CPU.

The reference has no Pallas backward for either scan: it differentiates its
XLA paths with ``jax.vjp``. Inputs are made with numpy from a seed and go
through both packages:

- K3b's plain version (``linear_scan_bwd_plain``, which its wrapper runs
  for CPU tensors) against ``jax.vjp`` of the reference's
  ``kernels/linear_scan/ref.py::linear_scan_ref`` (h and the final state,
  with a nonzero final-state cotangent or none) and of
  ``modeling/rglru.py::rglru_scan`` (h alone), over 300 rows: two chunks of
  K3's 128 and a ragged tail;
- K6b's plain version (``ssd_scan_bwd_plain``) against ``jax.vjp`` of the
  reference's literal recurrence ``kernels/ssd_scan/ref.py::ssd_ref`` and
  of its chunked XLA path ``modeling/ssd.py::ssd_chunked``: 3 heads, 45
  rows in chunks of 16 (two full and a ragged tail), a nonzero final-state
  cotangent, float32 and bf16 inputs (the bf16 values go to JAX widened to
  float32, exactly);
- ``LinearScanFn`` and ``SSDScanFn`` (forward K3 / K6, backward K3b / K6b;
  on the CPU their plain versions) against torch autograd through
  ``linear_scan_plain`` / ``ssd_scan_plain``, called as the models call
  them, and the routing of ``ops.linear_scan`` / ``ops.ssd`` through them;
- ``chunk_states``, the states K6b reads from K6's workspace, against the
  plain forward's; and ``chip_smoke.py``'s planted K6b faults, each of
  which its bf16 row limit must see.

Tolerances: K3b float32 within 1e-5 (absolute and relative: the same
recurrence, summed in another order by the associative scan); K6b within
1e-5 (relative and absolute) of ``ssd_chunked``, the same chunked
formulas, and within 1e-4 of ``ssd_ref``, whose step-by-step decays round
otherwise; in bf16 every gradient within 2^-7 of its tensor's largest
|grad| (one or two bf16 roundings of an output near that scale). The
Functions against autograd through the plain forwards: float32 within
1e-5, bf16 within 2^-7 of the tensor's largest |grad|.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan.ref import linear_scan_ref
from repro.kernels.ssd_scan.ref import ssd_ref
from repro.modeling.rglru import rglru_scan
from repro.modeling.ssd import ssd_chunked
from repro_torch.kernels.linear_scan.kernel import (
    linear_scan_bwd_bsd,
    linear_scan_bwd_plain,
    linear_scan_plain,
)
from repro_torch.kernels.linear_scan.ops import LinearScanFn, linear_scan
from repro_torch.kernels.ssd_scan.kernel import (
    _padded_chunks,
    bwd_group,
    bwd_work_floats,
    chunk_states,
    reverse_cumsum,
    ssd_scan_bwd_bhsd,
    ssd_scan_bwd_plain,
    ssd_scan_plain,
    work_floats,
)
from repro_torch.kernels.ssd_scan.ops import SSDScanFn, ssd

SCAN_TOL = 1e-5
SSD_CHUNKED_TOL = 1e-5
SSD_REF_TOL = 1e-4
BF16_TOL = 2.0 ** -7
SSD_SHAPE = dict(b=2, H=3, S=45, hd=8, ds=16, chunk=16)


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_close(got, want, what):
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= BF16_TOL, (what, err)


# ------------------------------------------------------------- K3b
def _scan_inputs(rng, B=2, S=300, D=24):
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    a = rng.uniform(0.1, 1.0, size=(B, S, D)).astype(np.float32)
    dh = rng.normal(size=(B, S, D)).astype(np.float32)
    dfinal = rng.normal(size=(B, D)).astype(np.float32)
    return x, a, dh, dfinal


def _k3b_plain(x, a, dh, dfinal):
    xt, at = torch.as_tensor(x), torch.as_tensor(a)
    h, _ = linear_scan_plain(xt, at)
    return linear_scan_bwd_plain(torch.as_tensor(dh), None if dfinal is None
                                 else torch.as_tensor(dfinal), at, h)


@pytest.mark.parametrize("with_dfinal", [True, False],
                         ids=["dfinal", "no_dfinal"])
def test_linear_scan_bwd_plain_matches_ref_vjp(with_dfinal, rng):
    x, a, dh, dfinal = _scan_inputs(rng)
    if not with_dfinal:
        dfinal = np.zeros_like(dfinal)
    _, vjp = jax.vjp(linear_scan_ref, jnp.asarray(x), jnp.asarray(a))
    want = vjp((jnp.asarray(dh), jnp.asarray(dfinal)))
    got = _k3b_plain(x, a, dh, dfinal if with_dfinal else None)
    for g, w, name in zip(got, want, ("dx", "da")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCAN_TOL,
                                   atol=SCAN_TOL, err_msg=name)


def test_linear_scan_bwd_plain_matches_rglru_scan_vjp(rng):
    x, a, dh, _ = _scan_inputs(rng, B=1, S=257, D=40)
    _, vjp = jax.vjp(rglru_scan, jnp.asarray(x), jnp.asarray(a))
    want = vjp(jnp.asarray(dh))
    got = _k3b_plain(x, a, dh, None)
    for g, w, name in zip(got, want, ("dx", "da")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCAN_TOL,
                                   atol=SCAN_TOL, err_msg=name)


def test_linear_scan_bwd_wrapper_takes_plain_on_cpu(rng):
    x, a, dh, dfinal = _scan_inputs(rng, S=40)
    at = torch.as_tensor(a)
    h, _ = linear_scan_plain(torch.as_tensor(x), at)
    before = linear_scan_bwd_bsd.launches
    got = linear_scan_bwd_bsd(torch.as_tensor(dh), torch.as_tensor(dfinal),
                              at, h)
    want = linear_scan_bwd_plain(torch.as_tensor(dh),
                                 torch.as_tensor(dfinal), at, h)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert linear_scan_bwd_bsd.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("use_final", [True, False],
                         ids=["h_and_final", "h_only"])
def test_linear_scan_fn_matches_autograd_through_plain(use_final, rng):
    x, a, dh, dfinal = _scan_inputs(rng, S=150)
    leaves = [torch.tensor(t, requires_grad=True) for t in (x, a)]
    h, final = linear_scan(*leaves)
    assert type(h.grad_fn).__name__ == "LinearScanFnBackward"
    loss = (h * torch.as_tensor(dh)).sum() + (
        (final * torch.as_tensor(dfinal)).sum() if use_final else 0.0)
    got = torch.autograd.grad(loss, leaves)
    ref = [torch.tensor(t, requires_grad=True) for t in (x, a)]
    h2, final2 = linear_scan_plain(*ref)
    loss2 = (h2 * torch.as_tensor(dh)).sum() + (
        (final2 * torch.as_tensor(dfinal)).sum() if use_final else 0.0)
    want = torch.autograd.grad(loss2, ref)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=SCAN_TOL, atol=SCAN_TOL)


def test_linear_scan_routes_only_the_chunked_regime_through_the_fn(rng):
    x, a, _, _ = _scan_inputs(rng, S=20)
    xt = torch.tensor(x, requires_grad=True)
    at = torch.tensor(a, requires_grad=True)
    h, _ = linear_scan(xt, at)
    assert type(h.grad_fn).__name__ == "LinearScanFnBackward"
    with torch.no_grad():
        h, _ = linear_scan(xt, at)
        assert h.grad_fn is None
    # the fold regime (float64, or a == 1) keeps the differentiable plain
    # version on the CPU
    h, _ = linear_scan(xt.double(), at.double())
    assert "LinearScanFn" not in type(h.grad_fn).__name__
    h, _ = linear_scan(xt)
    assert "LinearScanFn" not in type(h.grad_fn).__name__


def test_linear_scan_fn_gives_no_gradient_for_unused_outputs(rng):
    x, a, _, _ = _scan_inputs(rng, S=20)
    xt = torch.tensor(x, requires_grad=True)
    at = torch.tensor(a, requires_grad=True)
    h, final = LinearScanFn.apply(xt, at)
    dx, da = torch.autograd.grad(final.sum(), (xt, at))
    # only the final state's cotangent: the last row's dx is 1
    assert torch.equal(dx[:, -1], torch.ones_like(dx[:, -1]))
    assert torch.isfinite(da).all()


# ------------------------------------------------------------- K6b
def _ssd_inputs(rng, dtype, b, H, S, hd, ds, chunk):
    """Model-layout inputs: x (b, S, H, hd), dt (b, S, H), A (H,), B and C
    slices of one (b, S, 2 ds + 3) projection, the cotangents dy (b, S, H,
    hd) and dstate (b, H, hd, ds); x, B, C and dy rounded to ``dtype``."""
    def rnd(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dtype)

    x = rnd(rng.normal(size=(b, S, H, hd)))
    dt = torch.as_tensor(rng.uniform(0.01, 0.6, size=(b, S, H)),
                         dtype=torch.float32)
    A = -torch.as_tensor(rng.uniform(0.5, 3.0, size=(H,)),
                         dtype=torch.float32)
    proj = rnd(rng.normal(size=(b, S, 2 * ds + 3)))
    B, C = proj[..., :ds], proj[..., ds + 1:2 * ds + 1]
    dy = rnd(rng.normal(size=(b, S, H, hd)))
    dstate = torch.as_tensor(rng.normal(size=(b, H, hd, ds)),
                             dtype=torch.float32)
    return x, dt, A, B, C, dy, dstate


def _k6b_plain(x, dt, A, B, C, dy, dstate, chunk):
    """K6b's plain version on model-layout inputs; gradients in the model's
    layout (dx (b, S, H, hd), ddt (b, S, H))."""
    dx, ddt, dA, dB, dC = ssd_scan_bwd_plain(
        x.transpose(1, 2), dt.transpose(1, 2), A, B, C, dy.transpose(1, 2),
        dstate, chunk=chunk)
    return dx.transpose(1, 2), ddt.transpose(1, 2), dA, dB, dC


def _jax_ssd_vjp(fn, x, dt, A, B, C, dy, dstate):
    args = [jnp.asarray(t.float().numpy()) for t in (x, dt, A, B, C)]
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy.float().numpy()),
                                        jnp.asarray(dstate.numpy())))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("ref", ["ssd_chunked", "ssd_ref"])
def test_ssd_scan_bwd_plain_matches_ref_vjp(ref, dtype, rng):
    shape = dict(SSD_SHAPE)
    chunk = shape.pop("chunk")
    ins = _ssd_inputs(rng, dtype, chunk=chunk, **shape)
    fn = (lambda x, dt, A, B, C: ssd_chunked(x, dt, A, B, C, chunk)) \
        if ref == "ssd_chunked" else ssd_ref
    want = _jax_ssd_vjp(fn, *ins)
    got = _k6b_plain(*ins, chunk)
    tol = SSD_CHUNKED_TOL if ref == "ssd_chunked" else SSD_REF_TOL
    for g, w, name in zip(got, want, ("dx", "ddt", "dA", "dB", "dC")):
        assert g.dtype == (ins[0].dtype if name in ("dx", "dB", "dC")
                           else torch.float32), name
        if dtype == torch.bfloat16:
            _bf16_close(g.float().numpy(), w, name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol,
                                       err_msg=name)


@pytest.mark.parametrize("S,chunk", [(16, 16), (1, 8), (100, 128), (70, 32)])
def test_ssd_scan_bwd_plain_other_chunkings_match_ssd_ref(S, chunk, rng):
    """One chunk (the serving route), one row, one chunk past 64 rows (the
    kernel's chunked route with a single chunk) and a ragged last chunk."""
    ins = _ssd_inputs(rng, torch.float32, 1, 2, S, 4, 8, chunk)
    want = _jax_ssd_vjp(ssd_ref, *ins)
    got = _k6b_plain(*ins, chunk)
    for g, w, name in zip(got, want, ("dx", "ddt", "dA", "dB", "dC")):
        np.testing.assert_allclose(g.numpy(), w, rtol=SSD_REF_TOL,
                                   atol=SSD_REF_TOL, err_msg=name)


def test_chunk_states_match_the_plain_forward(rng):
    x, dt, A, B, C, _, _ = _ssd_inputs(rng, torch.float32, chunk=16,
                                       **{k: v for k, v in SSD_SHAPE.items()
                                          if k != "chunk"})
    xt, dtt = x.transpose(1, 2), dt.transpose(1, 2)
    states = chunk_states(xt, dtt, A, B, chunk=16)
    assert states.shape == (2, 3, 3, 8, 16)
    assert torch.equal(states[:, 0], torch.zeros_like(states[:, 0]))
    for c in (1, 2):  # the final state of the first c chunks
        _, want = ssd_scan_plain(xt[:, :, :16 * c], dtt[:, :, :16 * c], A,
                                 B[:, :16 * c], C[:, :16 * c], chunk=16)
        torch.testing.assert_close(states[:, c], want, rtol=1e-6,
                                   atol=1e-6)


def test_ssd_scan_bwd_wrapper_takes_plain_on_cpu(rng):
    x, dt, A, B, C, dy, dstate = _ssd_inputs(rng, torch.float32, 1, 2, 20,
                                             4, 8, 8)
    args = (x.transpose(1, 2), dt.transpose(1, 2), A, B, C,
            dy.transpose(1, 2), dstate)
    before = ssd_scan_bwd_bhsd.launches
    got = ssd_scan_bwd_bhsd(*args, chunk=8)
    want = ssd_scan_bwd_plain(*args, chunk=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ssd_scan_bwd_bhsd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("use_state", [True, False],
                         ids=["y_and_state", "y_only"])
def test_ssd_fn_matches_autograd_through_plain(use_state, dtype, rng):
    shape = dict(SSD_SHAPE)
    chunk = shape.pop("chunk")
    x, dt, A, B, C, dy, dstate = _ssd_inputs(rng, dtype, chunk=chunk,
                                             **shape)
    proj = torch.cat([B, torch.zeros_like(B[..., :1]), C], -1)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, proj)]
        xs, dts, As, pr = leaves
        Bs, Cs = pr[..., :B.shape[-1]], pr[..., B.shape[-1] + 1:]
        y, state = fn(xs, dts, As, Bs, Cs)
        loss = (y.float() * dy.float()).sum()
        if use_state:
            loss = loss + (state * dstate).sum()
        return y, torch.autograd.grad(loss, leaves)

    y, got = run(lambda *a: ssd(*a, chunk=chunk))
    assert type(y.grad_fn.next_functions[0][0]).__name__ == \
        "SSDScanFnBackward"

    def plain(xs, dts, As, Bs, Cs):
        yk, st = ssd_scan_plain(xs.transpose(1, 2), dts.transpose(1, 2), As,
                                Bs, Cs, chunk=chunk)
        return yk.transpose(1, 2), st

    _, want = run(plain)
    for g, w, name in zip(got, want, ("x", "dt", "A", "proj")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if dtype == torch.bfloat16 and name in ("x", "proj"):
            _bf16_close(g.float().numpy(), w.float().numpy(), name)
        else:
            torch.testing.assert_close(g, w, rtol=SCAN_TOL, atol=SCAN_TOL,
                                       msg=name)


def test_ssd_routes_through_the_fn_only_under_autograd(rng):
    x, dt, A, B, C, _, _ = _ssd_inputs(rng, torch.float32, 1, 2, 20, 4, 8, 8)
    y, _ = ssd(x, dt.requires_grad_(True), A, B, C, chunk=8)
    assert type(y.grad_fn.next_functions[0][0]).__name__ == \
        "SSDScanFnBackward"
    with torch.no_grad():
        y, _ = ssd(x, dt, A, B, C, chunk=8)
    assert y.grad_fn is None and y.is_contiguous()


def test_ssd_fn_gives_no_gradient_for_unused_outputs(rng):
    x, dt, A, B, C, _, _ = _ssd_inputs(rng, torch.float32, 1, 2, 20, 4, 8, 8)
    leaves = [t.transpose(1, 2).clone().requires_grad_(True) for t in (x, dt)]
    y, state = SSDScanFn.apply(*leaves, A, B, C, 8)
    g = torch.autograd.grad(state.sum(), leaves)
    assert all(torch.isfinite(t).all() for t in g)


@pytest.mark.parametrize("b,H,S,chunk,sms,groups", [
    (2, 48, 2048, 128, 132, (6, 5)), (1, 3, 45, 16, 132, (1, 1)),
    (8, 64, 4096, 128, 132, (8, 8))])
def test_k6b_group_and_workspace(b, H, S, chunk, sms, groups):
    """The head groups (bf16: the fewest waves x heads; float32: two blocks
    an SM) and the workspace's length on both routes."""
    assert (bwd_group(b, H, S, chunk, sms),
            bwd_group(b, H, S, chunk, sms, torch.float32)) == groups
    g = bwd_group(b, H, S, chunk, sms)
    assert 1 <= g <= 8
    Q = min(chunk, S)
    nch = -(-S // Q)
    # the three float64 row buffers, then the float32 parts; the decayed
    # scores P and R only on the float32 route
    bf16 = 6 * b * H * S + b * nch * H * 64 * 128 + 2 * b * H * nch \
        + 2 * b * H * S + 2 * -(-H // g) * b * S * 128
    assert bwd_work_floats(b, H, S, 64, 128, chunk, g) == bf16
    assert bwd_work_floats(b, H, S, 64, 128, chunk, g, torch.bfloat16) == bf16
    assert bwd_work_floats(b, H, S, 64, 128, chunk, g, torch.float32) == \
        bf16 + 2 * b * nch * H * Q * Q
    assert work_floats(b, H, S, 64, 128, chunk) in (
        0, b * nch * H * 64 * 128 + b * H * nch)


@pytest.mark.parametrize("fault", ["cumsum", "carry", "head"])
def test_k6b_planted_faults_break_the_bf16_row_limit(fault, rng):
    """``chip_smoke.py``'s K6b faults, computed on the CPU: each breaks the
    bf16 row limit it holds the kernel to on the card, and the fault-free
    recomposition of the plain version lies within it."""
    smoke = _load_chip_smoke()
    x, dt, A, B, C, dy, dstate = _ssd_inputs(rng, torch.bfloat16, 1, 9, 45,
                                             8, 16, 16)
    args = (x.transpose(1, 2), dt.transpose(1, 2), A, B, C,
            dy.transpose(1, 2), dstate)
    want = ssd_scan_bwd_plain(*args, chunk=16)
    grads = lambda r: (r[0], r[1], r[2][None], r[3], r[4])  # noqa: E731
    clean = smoke.k6b_planted(*args, 16, None)
    assert smoke.k4b_row_err(grads(clean), grads(want)) <= 2.0 ** -20
    planted = smoke.k6b_planted(*args, 16, fault)
    assert smoke.k4b_row_err(grads(planted), grads(want)) > smoke.K4B_ROW_TOL


def _terms(t, n):
    """float32 ``t`` as n bf16 terms, hi (+ mid (+ lo)): each term the bf16
    rounding of what the earlier ones leave (``ssd_scan_bwd.cu``'s split)."""
    out, r = [], t
    for _ in range(n):
        term = r.to(torch.bfloat16).float()
        out.append(term)
        r = r - term
    return out


def _k6b_bf16_route(x, dt, A, B, C, dy, dstate, chunk, terms=3,
                    p_terms=None, out_dtype=None):
    """K6b's bf16 route emulated in torch on the CPU: C B^T and dy x^T from
    the exact bf16 operands; each product with a float32 operand (P, R,
    h_prev, dh_next, exp(cum) dy) summed over that operand's ``terms`` bf16
    terms (P's ``p_terms`` when given), each term times the exact bf16
    operand in float32; the sums of G, dt's direct part, dcum and dA in
    float64 as the kernel takes them. Kernel-layout inputs; returns (dx,
    ddt, dA, dB, dC), dx, dB and dC in ``out_dtype`` (x's by default)."""
    b, H, S, hd = x.shape
    Q = min(chunk, S)
    xf, dyf, dtf = (_padded_chunks(t, Q, 2) for t in (x, dy, dt))
    Bf, Cf = _padded_chunks(B, Q, 1), _padded_chunks(C, Q, 1)
    states = chunk_states(x, dt, A, B, chunk=chunk)

    def mm(a, exact, n=terms):  # float32 a times exact bf16, split
        return sum(t @ exact for t in _terms(a, n))

    a_ = A.float()[None, :, None]
    dh = dstate.float()
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (xf, dtf, Bf, Cf))
    dA = torch.zeros(H, dtype=torch.float64)
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    for c in range(states.shape[1] - 1, -1, -1):
        sl = slice(c * Q, (c + 1) * Q)
        xc, dyc, dtc = xf[:, :, sl], dyf[:, :, sl], dtf[:, :, sl]
        bc, cc, hp = Bf[:, None, sl], Cf[:, None, sl], states[:, c]
        cum = torch.cumsum((dtc * a_).double(), dim=-1).float()
        total = cum[..., -1:]
        L = torch.exp(torch.where(causal, cum[..., :, None]
                                  - cum[..., None, :], -2.0e38))
        W = L * dtc[..., None, :]
        CB, DX = cc @ bc.transpose(-1, -2), dyc @ xc.transpose(-1, -2)
        P, R = CB * W, DX * W
        G = (P * DX).double()
        e_cum, e_s = torch.exp(cum), torch.exp(total - cum)
        ew = e_s * dtc
        V = mm(dh, bc.transpose(-1, -2)).transpose(-1, -2)  # dh_next B_s
        HC = sum(dyc @ t for t in _terms(hp, terms))       # dy h_prev
        U = e_s * (xc * V).sum(-1)
        T = (dtc * U).double()
        dcum = G.sum(-1) - G.sum(-2) \
            + (e_cum * (cc * HC).sum(-1)).double() - T
        dcum[..., -1] += (torch.exp(total[..., 0])
                          * (dh * hp).sum((-2, -1))).double() + T.sum(-1)
        da = reverse_cumsum(dcum)
        dx[:, :, sl] = mm(P.transpose(-1, -2), dyc, p_terms or terms) \
            + ew[..., None] * V
        ddt[:, :, sl] = ((CB * DX * L).double().sum(-2) + U.double()
                         + A.double()[None, :, None] * da).float()
        dA += (dtc.double() * da).sum((0, 2))
        XD = sum(xc @ t for t in _terms(dh, terms))
        dB[:, sl] = (mm(R.transpose(-1, -2), cc) + ew[..., None] * XD).sum(1)
        dC[:, sl] = (mm(R, bc) + e_cum[..., None] * HC).sum(1)
        dh = torch.exp(total)[..., None] * dh \
            + mm((e_cum[..., None] * dyc).transpose(-1, -2), cc)
    out = out_dtype or x.dtype
    return (dx[:, :, :S].to(out), ddt[:, :, :S], dA.float(),
            dB[:, :S].to(out), dC[:, :S].to(out))


def test_k6b_bf16_split_holds_the_plain_version(rng):
    """The arithmetic of K6b's bf16 route, emulated on the CPU at a small
    shape (two full chunks and a ragged tail, a nonzero final-state
    cotangent): with every float32 operand split into three bf16 terms its
    float32 gradients lie within 1e-5 of each row's largest |grad| of the
    plain version's, and its bf16 outputs within ``K4B_ROW_TOL`` (the card's
    limit) with at least 4x to spare. Two terms and a single bf16 rounding
    of P alone (in P^T dy) move the gradients more; the test records their
    errors and P's margin to the limit (``-s`` prints them)."""
    smoke = _load_chip_smoke()
    x, dt, A, B, C, dy, dstate = _ssd_inputs(rng, torch.bfloat16, 1, 3, 45,
                                             8, 16, 16)
    args = (x.transpose(1, 2), dt.transpose(1, 2), A, B, C,
            dy.transpose(1, 2), dstate)
    rows = lambda r: (r[0], r[1], r[2][None], r[3], r[4])  # noqa: E731
    wide = [t.float() if t.dtype == torch.bfloat16 else t for t in args]
    want32 = ssd_scan_bwd_plain(*wide, chunk=16)
    split32 = _k6b_bf16_route(*args, 16, out_dtype=torch.float32)
    once32 = _k6b_bf16_route(*args, 16, p_terms=1, out_dtype=torch.float32)
    two32 = _k6b_bf16_route(*args, 16, terms=2, out_dtype=torch.float32)
    err_split = smoke.k4b_row_err(rows(split32), rows(want32))
    err_two = smoke.k4b_row_err(rows(two32), rows(want32))
    err_once = smoke.k4b_row_err(rows(once32), rows(want32))
    err_bf16 = smoke.k4b_row_err(rows(_k6b_bf16_route(*args, 16)),
                                 rows(ssd_scan_bwd_plain(*args, chunk=16)))
    print(f"K6b bf16 route: three terms {err_split:.3g}, two {err_two:.3g}, "
          f"P rounded once {err_once:.3g} ({smoke.K4B_ROW_TOL / err_once:.3g}x "
          f"under the limit), bf16 outputs {err_bf16:.3g} of "
          f"{smoke.K4B_ROW_TOL:.3g}")
    assert err_split <= 1e-5 and err_split <= err_two
    assert err_bf16 <= smoke.K4B_ROW_TOL / 4
    assert err_once > 100 * err_split


@pytest.mark.parametrize("fault", ["dfinal", "unshifted"])
def test_k3b_planted_faults_break_the_float32_limit(fault, rng):
    smoke = _load_chip_smoke()
    x, a, dh, dfinal = (torch.as_tensor(t) for t in _scan_inputs(rng, S=200))
    h, _ = linear_scan_plain(x, a)
    want = linear_scan_bwd_plain(dh, dfinal, a, h)
    got = smoke.k3b_planted(dh, dfinal, a, h, fault)
    assert smoke.k4b_f32_err(got, want) > smoke.K3B_TOL
