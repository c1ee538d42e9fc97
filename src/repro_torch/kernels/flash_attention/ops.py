"""Public wrapper of the flash-attention kernel in the model's layout."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, H, D).

    The kernel reads the (B, S, H, D) tensors as transposed views and writes
    its (B, Sq, H, D) output the same way: no layout copies and no padding
    (it masks the ragged edge of the key axis itself)."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         out=out.transpose(1, 2))
    return out
