"""RG-LRU recurrent block (Griffin / RecurrentGemma): the port of
``repro.modeling.rglru``.

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full Griffin recurrent block is: Wx -> causal conv1d (width 4) ->
RG-LRU, gated by a parallel GeLU branch, then an output projection.

Prefill and training run the recurrence through the linear-scan kernel
(K3, ``kernels/linear_scan``; its ``"chunked"`` float32 regime, and under
autograd its Function, whose backward is K3b), which launches its CUDA
kernels for CUDA tensors and runs its plain versions for CPU tensors,
whatever ``impl`` says (the reference picks its associative scan,
``rglru_scan`` here too, or its Pallas kernel by ``impl``). Decoding is the
single fused state update ``h = a * state + inp``, plain torch as in the
reference (which has no kernel there either); it updates the ``state`` and
``conv_state`` it is given in place, so a decode step captures in a CUDA
graph over static buffers.

The gate weights, the gate biases and ``lambda`` are used in float32, as the
reference uses its float32 parameters there (a bf16 activation times a
float32 weight promotes to float32); the other weights are cast to the
activation dtype. ``causal_conv1d`` is also the Mamba-2 block's
(``modeling/ssd.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.modeling.module import ParamSpec

RG_LRU_C = 8.0


def rglru_block_specs(cfg) -> dict[str, ParamSpec]:
    d, dr = cfg.d_model, cfg.d_rnn
    w = cfg.conv_width
    nb = getattr(cfg, "rglru_block_gates", 0)
    if nb:
        # Griffin §2.4: block-diagonal recurrence and input gates
        assert dr % nb == 0, (dr, nb)
        gate_a = ParamSpec((nb, dr // nb, dr // nb), ("rnn_blocks", None, None))
        gate_x = ParamSpec((nb, dr // nb, dr // nb), ("rnn_blocks", None, None))
    else:
        gate_a = ParamSpec((dr, dr), (None, "rnn"))
        gate_x = ParamSpec((dr, dr), (None, "rnn"))
    return {
        "wx": ParamSpec((d, dr), ("embed", "rnn")),
        "wy": ParamSpec((d, dr), ("embed", "rnn")),   # GeLU gate branch
        "wo": ParamSpec((dr, d), ("rnn", "embed")),
        "conv/w": ParamSpec((w, dr), (None, "rnn")),
        "conv/b": ParamSpec((dr,), ("rnn",), init="zeros"),
        "gate_a/w": gate_a,
        "gate_a/b": ParamSpec((dr,), ("rnn",), init="zeros"),
        "gate_x/w": gate_x,
        "gate_x/b": ParamSpec((dr,), ("rnn",), init="zeros"),
        "lambda": ParamSpec((dr,), ("rnn",), init="ones"),
    }


def _gate_proj(u, w):
    """u: (B, S, Dr); w dense (Dr, Dr) or block-diagonal (nb, Dr/nb, Dr/nb).
    Computed in the promoted dtype of the two, as the reference's einsum
    promotes a bf16 ``u`` and a float32 ``w`` to float32."""
    dt = torch.promote_types(u.dtype, w.dtype)
    u, w = u.to(dt), w.to(dt)
    if w.dim() == 3:
        nb = w.shape[0]
        B, S, Dr = u.shape
        ub = u.reshape(B, S, nb, Dr // nb)
        return torch.einsum("bsnr,nrq->bsnq", ub, w).reshape(B, S, Dr)
    return u @ w


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, without torch's threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


def _log_a(lam, r):
    # a_t = exp(-c * softplus(lambda) * r_t); computed in log space, float32
    return -RG_LRU_C * softplus(lam.float()) * r


def rglru_scan(x, a):
    """The associative scan of ``h_t = a_t h_{t-1} + x_t`` along axis 1
    (float32 in and out): the reference's XLA path, as log2(S) doubling
    steps of its combine ``(a_l a_r, a_r b_l + b_r)``. Plain torch, for the
    tests; the model runs K3."""
    S = x.shape[1]
    h, acc = x, a
    k = 1
    while k < S:
        h = torch.cat([h[:, :k], acc[:, k:] * h[:, :-k] + h[:, k:]], dim=1)
        acc = torch.cat([acc[:, :k], acc[:, k:] * acc[:, :-k]], dim=1)
        k *= 2
    return h


def causal_conv1d(x, w, b):
    """Depthwise causal temporal conv. x: (B, S, D); w: (W, D); b: (D,).
    The taps are summed as the reference sums them: from zeros, tap 0
    first, then the bias."""
    W = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[i]
    return out + b


def rglru_block_apply(cfg, p, x, state=None, conv_state=None, impl="xla"):
    """The Griffin recurrent block.

    Prefill and training: x (B, S, D), state None -> (y, final state (B, Dr)
    float32, conv state (B, W-1, Dr)). Decode: x (B, 1, D) with the carried
    ``state`` (B, Dr) float32 and ``conv_state`` (B, W-1, Dr), both updated
    in place and returned. ``impl`` is accepted for the reference's
    signature and not routed on: the recurrence of a prefill always goes
    through K3."""
    dt = x.dtype
    u = x @ p["wx"].to(dt)
    gate = F.gelu(x @ p["wy"].to(dt), approximate="tanh")

    w, bias = p["conv/w"].to(dt), p["conv/b"].to(dt)
    W = w.shape[0]
    if conv_state is None:
        u_conv = causal_conv1d(u, w, bias)
        conv_state = u[:, -(W - 1):, :] if u.shape[1] >= W - 1 else F.pad(
            u, (0, 0, W - 1 - u.shape[1], 0))
    else:
        hist = torch.cat([conv_state, u], dim=1)  # (B, W, Dr)
        u_conv = (torch.einsum("bwr,wr->br", hist, w) + bias)[:, None, :]
        conv_state.copy_(hist[:, 1:, :])

    r = torch.sigmoid(_gate_proj(u_conv, p["gate_a/w"]).float()
                      + p["gate_a/b"].float())
    i = torch.sigmoid(_gate_proj(u_conv, p["gate_x/w"]).float()
                      + p["gate_x/b"].float())
    log_a = _log_a(p["lambda"], r)  # (B, S, Dr) float32
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    inp = beta * i * u_conv.float()

    if state is None:
        h, state = ls_ops.linear_scan(inp, a)
    else:
        h = a * state[:, None, :] + inp  # a single step
        state.copy_(h[:, -1, :])

    y = h.to(dt) * gate
    return y @ p["wo"].to(dt), state, conv_state
