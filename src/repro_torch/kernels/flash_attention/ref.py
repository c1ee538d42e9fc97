"""The literal attention oracle: the full (Sq, Skv) softmax (port of the
JAX package's ``kernels/flash_attention/ref.py``)."""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, H, D) in q's dtype.

    The full (B, Hkv, G, Sq, Skv) score matrix in float32, masked with
    ``NEG_INF``, softmax normalised by ``max(sum, 1e-30)`` before the
    product with V: the memory-unbounded reference. A query row with no
    visible key gives the mean of V here (every score is ``NEG_INF``),
    where the kernel and its plain version give 0."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / (D ** 0.5)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
