"""Oracles for the GBRT kernels: the heap walk of ``GBRT.predict`` (numpy)
and the kernels' step-table method (torch)."""

from __future__ import annotations

import numpy as np
import torch


def gbrt_predict_ref(x, features, thresholds, leaves, *, depth: int, lr: float,
                     base: float) -> np.ndarray:
    """``x`` (N, F); the same walk as ``repro_torch.core.gbrt._predict_tree``,
    summed from ``base`` in tree order, in float64."""
    x = np.asarray(x, np.float64)
    out = np.full(x.shape[0], base, np.float64)
    for t in range(features.shape[0]):
        node = np.zeros(x.shape[0], np.int64)
        for _ in range(depth):
            go_right = x[np.arange(x.shape[0]), features[t][node]] \
                > thresholds[t][node]
            node = 2 * node + 1 + go_right.astype(np.int64)
        out += lr * leaves[t][node - (2 ** depth - 1)]
    return out


def gbrt_step_table_ref(x, breaks, counts, walk) -> torch.Tensor:
    """The GBRT kernels' step-table method over ``x`` (N, F).

    ``breaks`` (n, W) and ``counts``: feature ``f``'s sorted distinct
    thresholds, +inf padded, for feature ids ``0 .. n - 1`` (n <= F), as
    ``ops.step_breaks`` gives them; ``walk`` maps (M, F) points to the
    ensemble's (M, ...) predictions (a plain walk). The walk runs once per
    cell, at feature ``f``'s ``k``-th break (+inf past the last); a row
    takes the cell of its ranks ``k_f = #{b < x_f}``
    (``searchsorted(side="left")``), and a NaN, which walks left at every
    node as the first break does, takes ``k_f = 0``.
    """
    n = breaks.shape[0]
    axes = [breaks[f, :counts[f] + 1] for f in range(n)]
    grid = torch.meshgrid(*axes, indexing="ij")
    pts = torch.zeros((grid[0].numel(), x.shape[1]), dtype=x.dtype,
                      device=x.device)
    for f, g in enumerate(grid):
        pts[:, f] = g.reshape(-1)
    table = walk(pts)
    cell = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    for f in range(n):
        xf = x[:, f].contiguous()
        k = torch.searchsorted(breaks[f, :counts[f]].contiguous(), xf,
                               side="left")
        cell = cell * (counts[f] + 1) + torch.where(torch.isnan(xf), 0, k)
    return table[cell]
