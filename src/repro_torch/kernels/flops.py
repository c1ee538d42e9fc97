"""Operation counts of the model kernels (K3-K6, K3b, K4b, K6b), for
``kernels.counting`` and the dry run's cost analysis.

Each function returns ``(work, dense)``:

- ``work``: the operations the kernel's own work takes, counted as the
  bounds of ``chip_smoke.py`` (and ``PERF.md``) count them: attention over
  the (query, key) pairs its mask leaves live; the scans' multiply-adds per
  element; the SSD's products over each chunk's causal triangle;
- ``dense``: the floating-point operations that ``FlopCounterMode`` counts
  when the kernel's plain version runs instead (its matrix products over
  whole padded blocks, masked pairs included; 0 for the scans, whose plain
  versions are element-wise folds that it does not count).

Shapes are the wrappers' own (``(B, H, S, D)`` for the attention kernels,
``(b, H, S, hd)`` for the SSD, ``(B, S, D)`` for the linear scan).
"""

from __future__ import annotations

import numpy as np


def live_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs with key j visible to query i: ``j <= i``
    when causal, ``j > i - window`` with a window."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window and window > 0 \
        else np.zeros(Sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention(B, H, Sq, Skv, D, causal, window):
    """K4: S = QK^T and P.V over the live pairs (the plain version: over
    every pair)."""
    return (4.0 * B * H * live_pairs(Sq, Skv, causal, window) * D,
            4.0 * B * H * Sq * Skv * D)


def attention_bwd(B, H, Sq, Skv, D, causal, window):
    """K4b: the recompute of S and four products (dP, dV, dQ, dK) over the
    live pairs (the plain version: the same five over every pair)."""
    return (10.0 * B * H * live_pairs(Sq, Skv, causal, window) * D,
            10.0 * B * H * Sq * Skv * D)


def decode(B, H, S, D):
    """K5: q.K and P.V over every slot of the cache (the lengths are data;
    a decode cell's cache is full)."""
    return 4.0 * B * H * S * D, 4.0 * B * H * S * D


def linear_scan(B, S, D, gated: bool):
    """K3: one add per element, and one multiply with a gate."""
    return (2.0 if gated else 1.0) * B * S * D, 0.0


def linear_scan_bwd(B, S, D):
    """K3b: per element the carry's add, the gate's multiply and da's
    multiply."""
    return 3.0 * B * S * D, 0.0


def _chunks(S: int, chunk: int):
    Q = min(chunk, S)
    return Q, [min(Q, S - r0) for r0 in range(0, S, Q)]


def ssd(b, H, S, hd, ds, chunk):
    """K6: per chunk C B^T (shared by the heads) over the causal triangle,
    the scores times x, the state update, and after the first chunk the
    carried state's part of y. The plain version: the same products over
    whole zero-padded Q x Q chunks, each chunk's state update included."""
    Q, sizes = _chunks(S, chunk)
    work = 0.0
    for n, qc in enumerate(sizes):
        tri = qc * (qc + 1) / 2
        work += b * 2 * tri * ds + b * H * (2 * tri * hd + 2 * qc * hd * ds)
        if n:
            work += b * H * 2 * qc * hd * ds
    dense = len(sizes) * (2.0 * b * Q * Q * ds + 2.0 * b * H * Q * Q * hd
                          + 4.0 * b * H * Q * hd * ds)
    return work, dense


def ssd_bwd(b, H, S, hd, ds, chunk):
    """K6b: the products its bound counts (``chip_smoke.k6b_bound``): C B^T
    and dy x^T over the triangle, P^T dy, R B, R^T C, and the state terms.
    The plain version: nine products per zero-padded chunk and the chunk
    states' update again."""
    Q, sizes = _chunks(S, chunk)
    work = 0.0
    for n, qc in enumerate(sizes):
        tri = qc * (qc + 1) / 2
        work += b * 2 * tri * ds + b * H * 2 * tri * hd
        work += b * H * (2 * tri * hd + 4 * tri * ds + 4 * qc * hd * ds)
        if n:
            work += b * H * 4 * qc * hd * ds
    dense = len(sizes) * (2.0 * b * Q * Q * ds + 4.0 * b * H * Q * Q * hd
                          + 4.0 * b * H * Q * Q * ds
                          + 10.0 * b * H * Q * hd * ds)
    return work, dense
