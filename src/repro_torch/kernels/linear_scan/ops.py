"""Public wrappers of the linear-scan kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan.kernel import linear_scan_bsd


def linear_scan(x: torch.Tensor, a: torch.Tensor | None = None):
    """x, a: (B, S, D). Returns (h (B, S, D), final_state (B, D)) of
    ``h_t = a_t * h_{t-1} + x_t`` (``a=None``: a == 1), in ``x``'s dtype."""
    return linear_scan_bsd(x.contiguous(),
                           None if a is None else a.contiguous())


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D sequence through the scan kernel
    (a == 1): ``out[i] = (...((0 + x[0]) + x[1]) ...) + x[i]``, a strict left
    fold — in float64 bit-identical to ``np.cumsum`` (a sequential loop).
    The placement core's Alg. 1 surplus bank runs through it."""
    y, _ = linear_scan_bsd(x.contiguous()[None, :, None])
    return y[0, :, 0]
