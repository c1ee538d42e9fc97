"""Shared layers: norms, rotary embeddings, activations.

The port of ``repro.modeling.layers``, operation for operation: norms compute
in float32 and cast back; RMSNorm scales by ``1 + scale`` with eps 1e-6;
RoPE rotates the two halves of the head dimension with float32 frequencies
computed in numpy exactly as the reference does; the encoder's sinusoidal
positions are computed in numpy float64 as the reference computes them and
cast once; GELU is the tanh approximation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.modeling.module import ParamSpec


# --------------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dt)


def np_layer_norm(x, eps: float = 1e-5):
    """Non-parametric LayerNorm (OLMo): no learned scale/bias."""
    return layer_norm(x, None, None, eps)


def apply_norm(kind: str, x, params: dict, prefix: str):
    if kind == "rmsnorm":
        return rms_norm(x, params[f"{prefix}/scale"])
    if kind == "layernorm":
        return layer_norm(x, params[f"{prefix}/scale"], params[f"{prefix}/bias"])
    if kind == "np_layernorm":
        return np_layer_norm(x)
    raise ValueError(f"unknown norm {kind!r}")


def norm_specs(kind: str, d: int) -> dict[str, ParamSpec]:
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), init="zeros")}
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), init="ones"),
                "bias": ParamSpec((d,), ("embed",), init="zeros")}
    if kind == "np_layernorm":
        return {}
    raise ValueError(f"unknown norm {kind!r}")


def softcap(logits, cap: float):
    """``tanh(logits / cap) * cap`` (Gemma-style logit soft-capping); the
    logits unchanged when ``cap`` is 0."""
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits


# ---------------------------------------------------------------- activations
def activation(kind: str, x, x_gate=None):
    """Gated activations take (gate_input, linear_input)."""
    if kind == "swiglu":
        return F.silu(x) * x_gate
    if kind == "geglu":
        return F.gelu(x, approximate="tanh") * x_gate
    if kind == "sqrelu":  # Nemotron-4: squared ReLU
        r = F.relu(x)
        return r * r
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def is_gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


# --------------------------------------------------------------------- rotary
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


_FREQS: dict = {}


def _device_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """``rope_frequencies`` as a tensor on ``device``, copied there once: a
    decode step captured in a CUDA graph must not copy from the host."""
    key = (head_dim, float(theta), str(device))
    t = _FREQS.get(key)
    if t is None:
        t = _FREQS[key] = torch.as_tensor(rope_frequencies(head_dim, theta),
                                          device=device)
    return t


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D) with matching integer positions (..., S), which may
    be a device tensor (the decode step's position lives on the card)."""
    d = x.shape[-1]
    freqs = _device_frequencies(d, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, d/2)
    sin = torch.sin(angles)[..., None, :]  # broadcast over heads
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=8)
def sinusoidal_positions(seq_len: int, d_model: int, dtype=torch.float32,
                         device=None):
    """(seq_len, d_model) sinusoidal position table: the sines of
    ``pos / 10000 ** (2 i / d_model)`` then their cosines, computed in numpy
    float64 as the reference computes them and cast once to ``dtype`` on the
    CPU, so it equals the reference's bit for bit on every device. A table
    is made once per (shape, dtype, device) and kept (at 32,768 frames and
    width 1,280 it is 42 M float64 sines and cosines on the host): callers
    must not write to it."""
    pos = np.arange(seq_len)[:, None]
    i = np.arange(d_model // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d_model)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.as_tensor(emb).to(dtype).to(device)
