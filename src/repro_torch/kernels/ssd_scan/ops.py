"""Public wrapper of the SSD scan kernel in the model's layout, and its
autograd Function."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.kernel import (
    ssd_scan_bhsd,
    ssd_scan_bwd_bhsd,
    work_floats,
)


def _empty_bshd_view(like):
    """An uninitialised (b, H, S, hd) tensor laid out as (b, S, H, hd): the
    transposed view of a contiguous model-layout tensor."""
    b, H, S, hd = like.shape
    return torch.empty((b, S, H, hd), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


class SSDScanFn(torch.autograd.Function):
    """The SSD scan over kernel-layout operands (``ssd_scan_bhsd``'s) with a
    kernel on each side: the forward is K6, which on the card also leaves
    the state entering each chunk in the workspace it is given, the
    backward K6b (``ssd_scan_bwd_bhsd``), which reads it; on CPU tensors
    their plain versions. y and dx are transposed views of (b, S, H, hd)
    storage, so the model's layout round-trips without copies; the other
    gradients come back in their inputs' dtypes and shapes. Under
    ``torch.utils.checkpoint`` the recompute runs this forward again, so it
    relaunches K6 (and saves its workspace again).

    The forward keeps the ``kernels.recording`` tally open on its thread,
    and the backward, which autograd runs on its own device thread, counts
    K6b there, as ``FlashAttentionFn`` counts K4b."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        work = None
        if x.device.type != "cpu":
            b, H, S, hd = x.shape
            nw = work_floats(b, H, S, hd, B.shape[-1], chunk)
            if nw:
                work = torch.empty(nw, dtype=torch.float32, device=x.device)
        y, state = ssd_scan_bhsd(x, dt, A, B, C, chunk=chunk,
                                 out=_empty_bshd_view(x), work=work)
        ctx.save_for_backward(x, dt, A, B, C, work)
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.tally = _build.current_tally()
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        if dy is None and dstate is None:
            return None, None, None, None, None, None
        x, dt, A, B, C, work = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        elif dy.stride(-1) != 1:
            dy = dy.contiguous()
        dx, ddt, dA, dB, dC = ssd_scan_bwd_bhsd(
            x, dt, A, B, C, dy,
            None if dstate is None else dstate.contiguous(), chunk=ctx.chunk,
            work=work,
            dx=_empty_bshd_view(x), tally=ctx.tally)
        return dx, ddt, dA, dB, dC, None


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """x: (b, S, nh, hd); dt: (b, S, nh) float32 (after the softplus); A:
    (nh,); B/C: (b, S, ds) in x's dtype. Returns (y (b, S, nh, hd) in x's
    dtype, final state (b, nh, hd, ds) float32).

    The chunk is ``Q = min(chunk, S)``; a ragged tail chunk is zero-padded
    (dt = 0 there: no decay and no input, so the state passes through
    unchanged), by the plain version on the CPU and by the kernel's masking
    on the card. The kernel reads x, dt, B and C as strided views and writes
    y the same way: no layout copies. When autograd needs a gradient
    through the call it goes through ``SSDScanFn`` on every device (forward
    K6, backward K6b; their plain versions on the CPU); otherwise the
    kernel alone runs, as when serving."""
    xt, dtt = x.transpose(1, 2), dt.float().transpose(1, 2)
    A = A.float().contiguous()
    if _build.needs_grad(x, dt, A, B, C):
        y, state = SSDScanFn.apply(xt, dtt, A, B, C, chunk)
        return y.transpose(1, 2), state
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _, state = ssd_scan_bhsd(xt, dtt, A, B, C, chunk=chunk,
                             out=y.transpose(1, 2))
    return y, state
