"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

The port of ``repro.modeling.ssd``. Selective state space with a scalar A
per head:

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t       (state: (heads, hd, ds))
    y_t = C_t . h_t + D x_t

The prefill and training SSD of ``ssd_block_apply`` goes through the SSD
scan kernel (K6, ``kernels/ssd_scan``; under autograd its Function, whose
backward is K6b), which launches its CUDA kernels for CUDA tensors and runs
its plain versions for CPU tensors; ``impl`` is accepted for the
reference's signature and not routed on. The kernel computes in float32 and
rounds only y (the reference's XLA path, ``ssd_chunked`` here too, rounds the
intra-chunk scores to the input dtype before the product with x, so in bf16
its two paths differ slightly; the port follows the kernel). ``ssd_naive``,
the literal recurrence, is the oracle for both.

Decode is a single O(1) state update, plain torch as in the reference (it
has no kernel). It updates the ``state`` and ``conv_state`` it is given in
place (the cache's slices, so that a decode step captures in a CUDA graph
over static buffers) and returns them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.modeling.layers import rms_norm
from repro_torch.modeling.module import ParamSpec
from repro_torch.modeling.rglru import causal_conv1d, softplus


def ssd_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def ssd_block_specs(cfg) -> dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, nh, hd, ds = ssd_dims(cfg)
    w = cfg.conv_width
    conv_dim = d_inner + 2 * ds
    return {
        # in_proj -> [z (d_inner), x (d_inner), B (ds), C (ds), dt (nh)]
        "in_proj": ParamSpec((d, 2 * d_inner + 2 * ds + nh), ("embed", "rnn")),
        "conv/w": ParamSpec((w, conv_dim), (None, "rnn")),
        "conv/b": ParamSpec((conv_dim,), ("rnn",), init="zeros"),
        "a_log": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "d_skip": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "norm/scale": ParamSpec((d_inner,), ("rnn",), init="zeros"),
        "out_proj": ParamSpec((d_inner, d), ("rnn", "embed")),
    }


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q) with out[i, j] = sum_{k=j+1..i} x_k, -inf
    above the diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=x.device)
    return torch.where(i[:, None] >= i[None, :], seg, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """The reference's chunked XLA path. x: (b, S, nh, hd); dt: (b, S, nh)
    float32 (after the softplus); A: (nh,) negative; B, C: (b, S, ds) (one
    group, shared by the heads). Returns y (b, S, nh, hd) and the final state
    (b, nh, hd, ds) float32."""
    b, S, nh, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        # zero-dt padding is inert: decay exp(0) = 1, zero input contribution
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (S + pad) // Q
    dtype = x.dtype
    f32 = torch.float32

    xq = x.reshape(b, nc, Q, nh, hd)
    dtq = dt.reshape(b, nc, Q, nh)
    Bq = B.reshape(b, nc, Q, ds)
    Cq = C.reshape(b, nc, Q, ds)

    dA = dtq * A                                        # (b, nc, Q, nh)
    dA_cum = torch.cumsum(dA, dim=2)
    dA_total = dA_cum[:, :, -1, :]                      # (b, nc, nh)

    # ---- intra-chunk (quadratic, attention-like) ----------------------
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))      # (b, nc, nh, Q, Q)
    scores = torch.einsum("bcqn,bcsn->bcqs", Cq.to(f32), Bq.to(f32))
    att = scores[:, :, None, :, :] * L
    att = att * dtq.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", att.to(dtype), xq)

    # ---- chunk boundary states ----------------------------------------
    decay_to_end = torch.exp(dA_total[:, :, None, :] - dA_cum)
    weighted_x = xq.to(f32) * (dtq * decay_to_end)[..., None]
    states = torch.einsum("bcqhp,bcqn->bchpn", weighted_x, Bq.to(f32))

    # ---- inter-chunk recurrence (a short loop over the chunks) --------
    h = torch.zeros((b, nh, hd, ds), dtype=f32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)  # the state entering chunk c
        h = h * torch.exp(dA_total[:, c])[:, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                 # (b, nc, nh, hd, ds)

    # ---- inter-chunk output contribution ------------------------------
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cq.to(f32), h_prev) \
        * torch.exp(dA_cum)[..., None]
    y = y_intra.to(f32) + y_inter
    return y.reshape(b, S + pad, nh, hd)[:, :S].to(dtype), h


def ssd_naive(x, dt, A, B, C):
    """The literal recurrence (float32), the oracle: ``ssd_ref`` on x in
    float32. Same shapes as ``ssd_chunked``; y is float32."""
    return ssd_ref(x.float(), dt, A, B, C)


def ssd_block_apply(cfg, p, x, state=None, conv_state=None, impl="xla"):
    """The Mamba-2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    Prefill: x (B, S, D), state None. Decode: x (B, 1, D), state
    (B, nh, hd, ds) float32 and conv_state (B, W-1, conv_dim), both updated
    in place. Returns (y (B, S, D), state, conv_state)."""
    d_inner, nh, hd, ds = ssd_dims(cfg)
    dtype = x.dtype
    Bsz, S = x.shape[:2]
    W = p["conv/w"].shape[0]
    w, bias = p["conv/w"].to(dtype), p["conv/b"].to(dtype)

    zxbcdt = x @ p["in_proj"].to(dtype)
    z = zxbcdt[..., :d_inner]
    # [x, B, C] lie side by side in the projection: the reference's concat
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * ds]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * ds:]
    if conv_state is None:
        xBC_conv = causal_conv1d(xBC, w, bias)
        conv_state = xBC[:, -(W - 1):, :]
    else:
        hist = torch.cat([conv_state, xBC], dim=1)
        xBC_conv = (torch.einsum("bwr,wr->br", hist, w) + bias)[:, None, :]
        conv_state.copy_(hist[:, 1:, :])
    xBC_conv = F.silu(xBC_conv)

    xs = xBC_conv[..., :d_inner].reshape(Bsz, S, nh, hd)
    Bs = xBC_conv[..., d_inner:d_inner + ds]
    Cs = xBC_conv[..., d_inner + ds:]
    A = -torch.exp(p["a_log"].float())
    dt = softplus(dt_raw.float() + p["dt_bias"].float())

    if state is None:
        y, state = ssd_ops.ssd(xs, dt, A, Bs, Cs, chunk=cfg.ssm_chunk)
    else:
        decay = torch.exp(dt[:, 0] * A)[:, :, None, None]  # (B, nh, 1, 1)
        upd = (dt[:, 0][:, :, None] * xs[:, 0].float())[..., None] \
            * Bs[:, 0].float()[:, None, None, :]
        state.mul_(decay).add_(upd)
        y = torch.einsum("bhpn,bn->bhp", state, Cs[:, 0].float())
        y = y[:, None].to(dtype)

    y = y + xs * p["d_skip"].to(dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, d_inner)
    y = rms_norm(y, p["norm/scale"]) * F.silu(z)
    return y.to(dtype) @ p["out_proj"].to(dtype), state, conv_state
