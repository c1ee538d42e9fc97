"""Public wrapper of the flash-decode kernel in the model's layout."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_bhd


def decode_attention(q, k_cache, v_cache, lengths):
    """q: (B, 1, H, D); caches: (B, S, Hkv, D); lengths: (B,) int32
    -> (B, 1, H, D). The caches are read as transposed views (no copy, no
    padding)."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    decode_attention_bhd(q.transpose(1, 2), k_cache.transpose(1, 2),
                         v_cache.transpose(1, 2), lengths,
                         out=out.transpose(1, 2))
    return out
