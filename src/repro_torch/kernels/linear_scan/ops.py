"""Public wrappers of the linear-scan kernel, and its autograd Function."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.linear_scan.kernel import (
    linear_scan_bsd,
    linear_scan_bwd_bsd,
    scan_regime,
)


class LinearScanFn(torch.autograd.Function):
    """The chunked float32 scan with a kernel on each side: the forward is
    K3 (``linear_scan_bsd``), the backward K3b (``linear_scan_bwd_bsd``),
    which reads the saved ``a`` and the forward's output h; on CPU tensors
    their plain versions. An unused output gets no gradient (autograd hands
    the backward None for it, and an unused final state seeds nothing).

    The forward keeps the ``kernels.recording`` tally open on its thread,
    and the backward, which autograd runs on its own device thread, counts
    K3b there, as ``FlashAttentionFn`` counts K4b."""

    @staticmethod
    def forward(ctx, x, a):
        h, state = linear_scan_bsd(x, a)
        ctx.save_for_backward(a, h)
        ctx.set_materialize_grads(False)
        ctx.tally = _build.current_tally()
        return h, state

    @staticmethod
    def backward(ctx, dh, dfinal):
        if dh is None and dfinal is None:
            return None, None
        a, h = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else dh.contiguous()
        dx, da = linear_scan_bwd_bsd(
            dh, None if dfinal is None else dfinal.contiguous(), a, h,
            tally=ctx.tally)
        return dx, da


def linear_scan(x: torch.Tensor, a: torch.Tensor | None = None):
    """x, a: (B, S, D). Returns (h (B, S, D), final_state (B, D)) of
    ``h_t = a_t * h_{t-1} + x_t`` (``a=None``: a == 1), in ``x``'s dtype.

    When autograd needs a gradient through a chunked call (float32 with
    ``a``: the RG-LRU recurrence) it goes through ``LinearScanFn`` on every
    device (forward K3, backward K3b; their plain versions on the CPU);
    otherwise the kernel alone runs, as when serving."""
    x = x.contiguous()
    a = None if a is None else a.contiguous()
    if scan_regime(x, a) == "chunked" and _build.needs_grad(x, a):
        return LinearScanFn.apply(x, a)
    return linear_scan_bsd(x, a)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D sequence through the scan kernel
    (a == 1): ``out[i] = (...((0 + x[0]) + x[1]) ...) + x[i]``, a strict left
    fold — in float64 bit-identical to ``np.cumsum`` (a sequential loop).
    The placement core's Alg. 1 surplus bank runs through it."""
    y, _ = linear_scan_bsd(x.contiguous()[None, :, None])
    return y[0, :, 0]
