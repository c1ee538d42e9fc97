"""The literal decode-attention oracle: a length-masked softmax over the
whole cache (port of the JAX package's
``kernels/decode_attention/ref.py``)."""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q: (B, 1, H, D); caches: (B, S, Hkv, D); lengths: (B,) -> (B, 1, H, D)
    in q's dtype. Slot ``s`` of row ``b`` is valid when ``s < lengths[b]``;
    scores in float32, masked with ``NEG_INF``, normalised by
    ``max(sum, 1e-30)`` before the product with V. A length of 0 gives the
    mean of V here, where the kernel and its plain version give 0."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, 1, Hkv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k_cache.float()) / (D ** 0.5)
    valid = torch.arange(S, device=q.device)[None, :] \
        < lengths.to(q.device).long()[:, None]  # (B, S)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
