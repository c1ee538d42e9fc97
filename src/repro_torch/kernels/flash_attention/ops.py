"""Public wrapper of the flash-attention kernel in the model's layout, and
its autograd Function."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bhsd,
    flash_attention_bwd_bhsd,
)


def _empty_bshd_view(like):
    """An uninitialised (B, H, S, D) tensor laid out as (B, S, H, D): the
    transposed view of a contiguous model-layout tensor."""
    B, H, S, D = like.shape
    return torch.empty((B, S, H, D), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


class FlashAttentionFn(torch.autograd.Function):
    """Attention over (B, H, S, D) operands with a kernel on each side: the
    forward is K4 (``flash_attention_bhsd``), which also writes each row's
    log-sum-exp, the backward K4b (``flash_attention_bwd_bhsd``), which
    reads it; on CPU tensors their plain versions. The output and the
    gradients are transposed views of (B, S, H, D) storage, so the model's
    layout round-trips without copies. Under ``torch.utils.checkpoint`` the
    recomputation runs this forward again, so it relaunches K4 (and saves
    its lse again).

    The forward keeps the ``kernels.recording`` tally open on its thread,
    and the backward, which autograd runs on its own device thread, counts
    K4b there: a block around the forward and ``loss.backward()`` sees K4b.
    If that block has closed before the backward runs, the launch counts
    only in the wrapper's ``launches``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        B, H, S, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                   out=_empty_bshd_view(q), lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.tally = _build.current_tally()
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd_bhsd(
            q, k, v, out, do, causal=ctx.causal, window=ctx.window, lse=lse,
            dq=_empty_bshd_view(q), dk=_empty_bshd_view(k),
            dv=_empty_bshd_view(v), tally=ctx.tally)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, H, D).

    The kernel reads the (B, S, H, D) tensors as transposed views and writes
    its (B, Sq, H, D) output the same way: no layout copies and no padding
    (it masks the ragged edge of the key axis itself). When autograd needs a
    gradient through the call it goes through ``FlashAttentionFn`` (forward
    K4, backward K4b); otherwise the kernel alone runs, as when serving."""
    if _build.needs_grad(q, k, v):
        return FlashAttentionFn.apply(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
            window).transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         out=out.transpose(1, 2))
    return out
