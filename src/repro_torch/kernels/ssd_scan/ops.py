"""Public wrapper of the SSD scan kernel in the model's layout."""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bhsd


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """x: (b, S, nh, hd); dt: (b, S, nh) float32 (after the softplus); A:
    (nh,); B/C: (b, S, ds) in x's dtype. Returns (y (b, S, nh, hd) in x's
    dtype, final state (b, nh, hd, ds) float32).

    The chunk is ``Q = min(chunk, S)``; a ragged tail chunk is zero-padded
    (dt = 0 there: no decay and no input, so the state passes through
    unchanged), by the plain version on the CPU and by the kernel's masking
    on the card. The kernel reads x, dt, B and C as strided views and writes
    y the same way: no layout copies."""
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _, state = ssd_scan_bhsd(x.transpose(1, 2), dt.float().transpose(1, 2),
                             A.float().contiguous(), B, C, chunk=chunk,
                             out=y.transpose(1, 2))
    return y, state
