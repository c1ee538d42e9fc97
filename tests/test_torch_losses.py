"""The port's attention gradient and losses against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its port:

- K4b's plain version (``flash_attention_bwd_plain``, which its wrapper
  runs for CPU tensors) and ``FlashAttentionFn`` (K4's autograd Function:
  forward K4, backward K4b; on the CPU their plain versions) against
  ``jax.grad`` of the reference's XLA ``chunked_attention``, the attention
  the reference trains through (it has no Pallas backward): causal,
  windowed and bidirectional, MHA/GQA/MQA, head dims 16, 64 and 256;
- the row log-sum-exp K4 writes for K4b (``flash_attention_plain(...,
  return_lse=True)``, and ``flash_attention_bhsd(..., lse=)`` on CPU
  tensors) against a log-sum-exp of the reference's masked, scaled scores,
  and K4b's plain version fed it against the same without it;
- ``chunked_softmax_xent`` (one-hot and gather lookups, soft-capped, a
  chunk that does not divide S) and ``full_softmax_xent``, in value and in
  their gradients with respect to the hidden states and the unembedding.

Tolerances: float32 throughout; 1e-5 (relative and absolute) for the
attention gradients and the log-sum-exp, 1e-6 between K4b's plain version
with and without the forward's lse (the same formulas, P normalised by a
division or by the subtracted lse), 1e-5 for the loss values and 1e-6 for
the loss gradients (XLA and PyTorch sum in different orders).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.modeling.attention import _block_mask, chunked_attention
from repro.modeling.losses import chunked_softmax_xent as jax_chunked_xent
from repro.modeling.losses import full_softmax_xent as jax_full_xent
from repro_torch import kernels
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bhsd,
    flash_attention_bwd_bhsd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.modeling.losses import chunked_softmax_xent, full_softmax_xent

GRAD_TOL = 1e-5
LOSS_TOL = 1e-5
LOSS_GRAD_TOL = 1e-6
LSE_TOL = 1e-5
LSE_BWD_TOL = 1e-6

# (B, S, H, Hkv, D, causal, window)
ATTN_CASES = [(2, 40, 4, 2, 16, True, 0), (1, 37, 4, 1, 16, True, 9),
              (2, 33, 2, 2, 64, False, 0), (1, 48, 6, 3, 64, True, 16),
              (1, 30, 4, 2, 64, False, 7), (1, 24, 2, 1, 256, True, 0),
              (1, 29, 2, 2, 256, True, 11)]


def _jax_attention_grads(q, k, v, g, causal, window):
    """(out, dq, dk, dv) of the reference's XLA attention for the cotangent
    ``g``, in the model's (B, S, H, D) layout."""
    def f(q, k, v):
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=16)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(out), *(np.asarray(x) for x in vjp(jnp.asarray(g))))


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "B{}S{}H{}kv{}D{}{}w{}".format(
                             *c[:5], "c" if c[5] else "b", c[6]))
def test_attention_gradient_matches_reference(case, rng):
    B, S, H, Hkv, D, causal, window = case
    q, k, v = (rng.normal(size=(B, S, h, D)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    g = rng.normal(size=(B, S, H, D)).astype(np.float32)
    jo, jdq, jdk, jdv = _jax_attention_grads(q, k, v, g, causal, window)

    # the plain backward from the plain forward's output, (B, H, S, D)
    tq, tk, tv, tg = (torch.as_tensor(x).transpose(1, 2) for x in (q, k, v, g))
    o = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), jo, rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    kernels.reset_launch_counts()
    dq, dk, dv = flash_attention_bwd_bhsd(tq, tk, tv, o, tg, causal=causal,
                                          window=window)
    assert flash_attention_bwd_bhsd.launches == 0  # CPU: the plain version
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                                   rtol=GRAD_TOL, atol=GRAD_TOL)

    # FlashAttentionFn through autograd, in the model's layout
    xs = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*xs, causal=causal, window=window)
    assert out.grad_fn is not None and out.is_contiguous()
    out.backward(torch.as_tensor(g))
    for x, want in zip(xs, (jdq, jdk, jdv)):
        np.testing.assert_allclose(x.grad.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def _jax_lse(q, k, causal, window):
    """(B, H, Sq) log-sum-exp of the reference's masked, scaled scores
    (``_block_mask`` and the score einsum of ``_attend_block``), from (B, S,
    H, D) inputs."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(B, Sq, Hkv, H // Hkv, D)
    s = jnp.einsum("bqkgd,bskd->bkgqs", qg, jnp.asarray(k),
                   preferred_element_type=jnp.float32) / (D ** 0.5)
    mask = _block_mask(jnp.arange(Sq), jnp.arange(Skv), causal, window)
    lse = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
    return np.asarray(lse).reshape(B, H, Sq)


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "B{}S{}H{}kv{}D{}{}w{}".format(
                             *c[:5], "c" if c[5] else "b", c[6]))
def test_attention_lse_matches_reference(case, rng):
    """K4's row statistics: the plain version's ``return_lse`` and the
    wrapper's ``lse=`` on CPU tensors equal a log-sum-exp of the
    reference's masked, scaled scores; the output is the same with or
    without them."""
    B, S, H, Hkv, D, causal, window = case
    q, k, v = (rng.normal(size=(B, S, h, D)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    want = _jax_lse(q, k, causal, window)
    tq, tk, tv = (torch.as_tensor(x).transpose(1, 2) for x in (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                   return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(lse.numpy(), want, rtol=LSE_TOL, atol=LSE_TOL)
    assert torch.equal(o, flash_attention_plain(tq, tk, tv, causal=causal,
                                                window=window))
    buf = torch.full((B, H, S), float("nan"))
    kernels.reset_launch_counts()
    out = flash_attention_bhsd(tq, tk, tv, causal=causal, window=window,
                               lse=buf)
    assert flash_attention_bhsd.launches == 0  # CPU: the plain version
    assert torch.equal(out, o) and torch.equal(buf, lse)


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "B{}S{}H{}kv{}D{}{}w{}".format(
                             *c[:5], "c" if c[5] else "b", c[6]))
def test_attention_gradient_from_lse_matches_normalised(case, rng):
    """K4b's plain version with P from the forward's lse (as K4b forms it)
    equals the version that normalises P itself, and so does the wrapper on
    CPU tensors given that lse."""
    B, S, H, Hkv, D, causal, window = case
    q, k, v, g = (torch.as_tensor(rng.normal(size=(B, h, S, D)),
                                  dtype=torch.float32)
                  for h in (H, Hkv, Hkv, H))
    o, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, g, causal=causal,
                                     window=window)
    got = flash_attention_bwd_plain(q, k, v, o, g, causal=causal,
                                    window=window, lse=lse)
    via = flash_attention_bwd_bhsd(q, k, v, o, g, causal=causal,
                                   window=window, lse=lse)
    for a, b, c in zip(got, want, via):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=LSE_BWD_TOL,
                                   atol=LSE_BWD_TOL)
        assert torch.equal(a, c)


def test_attention_lse_of_a_row_without_keys_zeroes_its_gradient(rng):
    """A query row that sees no key (past the keys, causal) gets lse +inf,
    so every P of the row is exactly 0 and so are its output and its
    gradients, with or without lse."""
    q, g = (torch.as_tensor(rng.normal(size=(1, 2, 6, 8)), dtype=torch.float32)
            for _ in range(2))
    k, v = (torch.as_tensor(rng.normal(size=(1, 1, 4, 8)), dtype=torch.float32)
            for _ in range(2))
    o, lse = flash_attention_plain(q, k, v, causal=True, window=2,
                                   return_lse=True)
    assert torch.isinf(lse[..., 5:]).all() and (lse[..., 5:] > 0).all()
    assert torch.isfinite(lse[..., :5]).all()
    assert torch.equal(o[:, :, 5:], torch.zeros_like(o[:, :, 5:]))
    for lse_in in (None, lse):
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, g, causal=True,
                                               window=2, lse=lse_in)
        assert torch.equal(dq[:, :, 5:], torch.zeros_like(dq[:, :, 5:]))
        assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_attention_gradient_plain_formulas_match_autograd(rng):
    """The plain backward's explicit formulas equal autograd through the
    plain forward (the same float32 function), GQA and a window."""
    q = torch.as_tensor(rng.normal(size=(2, 6, 20, 16)), dtype=torch.float32)
    k, v = (torch.as_tensor(rng.normal(size=(2, 2, 20, 16)),
                            dtype=torch.float32) for _ in range(2))
    g = torch.as_tensor(rng.normal(size=(2, 6, 20, 16)), dtype=torch.float32)
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention_plain(*xs, causal=True, window=5)
    want = torch.autograd.grad(o, xs, g)
    got = flash_attention_bwd_plain(q, k, v, o.detach(), g, causal=True,
                                    window=5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _loss_inputs(rng, B, S, D, V):
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) / np.sqrt(D)).astype(np.float32)
    t = rng.integers(0, V, size=(B, S)).astype(np.int32)
    m = (rng.random((B, S)) < 0.8).astype(np.float32)
    return h, w, t, m


def _check_loss(jax_fn, port_fn, h, w, t, m):
    def jf(h, w):
        s, d = jax_fn(h, w, jnp.asarray(t), jnp.asarray(m))
        return s / d

    jl, (jgh, jgw) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.as_tensor(x).requires_grad_(True) for x in (h, w))
    s, d = port_fn(th, tw, torch.as_tensor(t), torch.as_tensor(m))
    assert s.dtype == d.dtype == torch.float32
    loss = s / d
    gh, gw = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), atol=LOSS_GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=LOSS_GRAD_TOL)


@pytest.mark.parametrize("impl", ["onehot", "gather"])
@pytest.mark.parametrize("cap", [0.0, 3.0])
@pytest.mark.parametrize("S,chunk", [(16, 4), (12, 5), (12, 64)])
def test_chunked_xent_matches_reference(impl, cap, S, chunk, rng):
    """Value and gradients; chunk 5 at S = 12 runs the largest divisor (4),
    chunk 64 one chunk."""
    h, w, t, m = _loss_inputs(rng, 2, S, 8, 50)
    _check_loss(
        lambda *a: jax_chunked_xent(*a, chunk=chunk, cap=cap, impl=impl),
        lambda *a: chunked_softmax_xent(*a, chunk=chunk, cap=cap, impl=impl),
        h, w, t, m)


@pytest.mark.parametrize("cap", [0.0, 3.0])
def test_full_xent_matches_reference(cap, rng):
    h, w, t, m = _loss_inputs(rng, 2, 10, 8, 50)
    _check_loss(lambda *a: jax_full_xent(*a, cap=cap),
                lambda *a: full_softmax_xent(*a, cap=cap), h, w, t, m)


def test_chunked_xent_equals_full_and_needs_no_grad(rng):
    """Chunking changes the summation order only; under ``no_grad`` the
    chunks run without checkpointing, with the same value."""
    h, w, t, m = (torch.as_tensor(x) for x in _loss_inputs(rng, 2, 16, 8, 30))
    s1, d1 = chunked_softmax_xent(h, w, t, m, chunk=4)
    s2, d2 = full_softmax_xent(h, w, t, m)
    with torch.no_grad():
        s3, _ = chunked_softmax_xent(h, w, t, m, chunk=4)
    np.testing.assert_allclose(float(s1), float(s2), rtol=1e-6)
    assert float(s1) == float(s3) and float(d1) == float(d2)
