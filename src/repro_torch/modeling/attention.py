"""Attention: GQA/MQA/MHA prefill and single-token decode.

The port of ``repro.modeling.attention``. The reference selects between a
chunked XLA path and its Pallas kernels by ``cfg.attn_impl``; in the port the
device decides, as everywhere in ``repro_torch``: ``attention`` goes through
the flash-attention kernel (K4) and ``decode_attention`` through the
flash-decode kernel (K5), which launch their CUDA kernels for CUDA tensors
and run their plain versions for CPU tensors. ``impl`` is accepted for the
reference's signature and not routed on. Both compute in float32 and round
only the output, as the TPU kernels do (the reference's XLA path rounds the
probabilities to the value dtype before the P·V product, so in bf16 its two
paths differ slightly; the port follows the kernels). Where a training step
needs a gradient through ``attention``, K4's autograd Function runs it, its
backward the hand-written flash-attention backward (K4b); the reference
differentiates its XLA path instead.

The windowed ring-buffer decode (a local-window cache with slot positions)
has no kernel in the reference either and stays plain torch here, computed
as the reference's XLA path computes it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -2.0e38


def attention(q, k, v, *, causal=True, window=0, impl="xla"):
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, H, D) through the
    flash-attention kernel; ``impl`` is not routed on. (The reference's
    ``q_chunk``, ``banded`` and context-parallel arguments shape its
    chunked XLA path, which the port does not have.)"""
    return fa_ops.flash_attention(q, k, v, causal=causal, window=window)


def _windowed_decode(q, k_cache, v_cache, length, window, positions):
    """The reference's XLA decode with a slot-position window filter."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k_cache.float()) * scale  # (B, Hkv, G, S)
    slot = torch.arange(S, device=q.device)
    valid = slot[None, :] < length[:, None].long()  # (B, S)
    if positions is not None:
        positions = positions.to(q.device)
        pos_b = positions.expand(B, S) if positions.dim() == 1 else positions
        cur = torch.where(valid, pos_b, -1).amax(dim=1, keepdim=True)
        valid &= pos_b > (cur - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    scores = scores - scores.amax(-1, keepdim=True)
    probs = torch.exp(scores)
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, D)


def decode_attention(q, k_cache, v_cache, length, *, window: int = 0,
                     positions=None, impl: str = "xla"):
    """Single-token attention against a KV cache.

    q: (B, 1, H, D); caches: (B, S, Hkv, D); length: (B,) int32 valid cache
    lengths (slots at index >= length are masked; a length above S leaves
    every slot valid). ``positions`` optionally gives each slot's absolute
    position (ring-buffer local-window caches). Without a window this is the
    flash-decode kernel; ``impl`` is not routed on."""
    if window and window > 0:
        return _windowed_decode(q, k_cache, v_cache, length, window, positions)
    return da_ops.decode_attention(q, k_cache, v_cache,
                                   length.to(torch.int32).contiguous())
