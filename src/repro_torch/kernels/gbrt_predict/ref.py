"""Numpy oracle for the GBRT kernels: the heap walk of ``GBRT.predict``."""

from __future__ import annotations

import numpy as np


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
