"""Numpy oracle for the linear-scan kernel: the recurrence step by step."""

from __future__ import annotations

import numpy as np


def linear_scan_ref(x, a=None):
    """x, a: (B, S, D). Returns (h (B, S, D), final_state (B, D)) of
    ``h_t = a_t * h_{t-1} + x_t`` from ``h_{-1} = 0`` in ``x``'s dtype."""
    x = np.asarray(x)
    y = np.empty_like(x)
    h = np.zeros((x.shape[0], x.shape[2]), x.dtype)
    for t in range(x.shape[1]):
        h = h + x[:, t] if a is None else np.asarray(a)[:, t] * h + x[:, t]
        y[:, t] = h
    return y, h
