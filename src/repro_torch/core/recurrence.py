"""Sequential recurrences evaluated as vectorized segment passes.

The serve path contains a handful of genuinely sequential recurrences — the
single-slot FIFO busy horizon, the surplus bank, the CIL warm/cold shadow —
that would otherwise force a per-task Python walk. The trick shared by all of
them: between "reset" events the recurrence is a plain running sum, and
``np.cumsum`` accumulates float64 strictly sequentially (``np.add.accumulate``
is a sequential loop), so each segment can be evaluated as one vectorized pass
that is BIT-IDENTICAL to the scalar loop.

``fifo_starts`` is the canonical instance (used by both the twin's ground-truth
executors and the Decision Engine's predicted edge queues);
``surplus_trajectory`` applies the same concat-then-cumsum device to Alg. 1's
budget bank. The columnar decision core (``repro_torch.core.decision``) builds its
speculate-and-repair passes out of these.
"""

from __future__ import annotations

import numpy as np


def fifo_starts(free: float, nows: np.ndarray,
                comp: np.ndarray) -> tuple[np.ndarray, float]:
    """Execution start times on one single-slot FIFO executor.

    Bitwise-identical to the scalar recurrence ``start_j = max(F, now_j);
    F = start_j + comp_j``: between idle periods the busy horizon is a plain
    running sum, and ``np.cumsum`` accumulates in the same sequential order,
    so each busy segment is one vectorized pass. Falls back to the scalar
    loop if the device goes idle many times (quiet workloads — cheap anyway).

    Returns ``(starts, final_free)``.
    """
    nd = nows.shape[0]
    start = np.empty(nd)
    pos = 0
    segments = 0
    while pos < nd and segments < 32:
        segments += 1
        f_trial = np.cumsum(np.concatenate(([free], comp[pos:])))
        viol = np.nonzero(nows[pos:] > f_trial[:-1])[0]
        if viol.size == 0:  # never idle again: the trial horizon is exact
            start[pos:] = f_trial[:-1]
            return start, float(f_trial[-1])
        k = int(viol[0])  # first idle gap: horizon resets to the arrival
        if k:
            start[pos:pos + k] = f_trial[:k]
        j = pos + k
        s = float(nows[j])
        start[j] = s
        free = s + float(comp[j])
        pos = j + 1
    if pos < nd:  # many idle periods: scalar recurrence for the tail
        nows_l = nows[pos:].tolist()
        comp_l = comp[pos:].tolist()
        for j in range(nd - pos):
            now_j = nows_l[j]
            s = free if free > now_j else now_j
            start[pos + j] = s
            free = s + comp_l[j]
    return start, float(free)


def horizon_before(free: float, nows: np.ndarray, comp: np.ndarray,
                   push_rows: np.ndarray, n_rows: int) -> tuple[np.ndarray, float]:
    """Busy horizon *before* each of ``n_rows`` decision rows, given pushes at
    ``push_rows`` (sorted row indices) with arrival/compute ``nows``/``comp``
    (both already gathered to the push subsequence).

    The horizon only advances at push rows (``h ← max(h, now) + comp``, the
    ``PredictedEdgeQueue.push`` recurrence == the FIFO start recurrence), so
    the trajectory is ``fifo_starts`` on the subsequence plus a forward fill
    across all rows. Returns ``(h_before, final_free)``.
    """
    if push_rows.size == 0:
        return np.full(n_rows, free), free
    starts, final = fifo_starts(free, nows, comp)
    horizons = starts + comp  # horizon right after each push
    counts = np.searchsorted(push_rows, np.arange(n_rows), side="left")
    h_before = np.concatenate(([free], horizons))[counts]
    return h_before, final


def surplus_trajectory(s0: float, c_max: float,
                       chosen_cost: np.ndarray) -> np.ndarray:
    """Alg. 1's surplus bank as one sequential-order cumsum.

    ``out[i]`` is the bank *before* decision ``i`` and ``out[-1]`` the bank
    after the last one — bit-identical to repeating
    ``surplus += c_max - cost`` because the initial value is folded into the
    cumsum (float addition is not associative; ``cumsum`` keeps the scalar
    loop's exact association).
    """
    return np.cumsum(np.concatenate(([s0], c_max - chosen_cost)))


def maxplus_combine(x, y, maximum=np.maximum):
    """Associative combine for the FIFO/edge-horizon recurrence in (max, +).

    ``h_i = max(h_{i-1}, now_i) + comp_i`` (a push) and ``h_i = h_{i-1}`` (no
    push) are both affine maps in the max-plus semiring, ``f(h) = max(h + a,
    b)`` with ``(a, b) = (comp, now + comp)`` resp. ``(0, -inf)``. Composition
    stays in that family — ``(f2 ∘ f1)(h) = max(h + (a1 + a2), max(b1 + a2,
    b2))`` — which is exactly this combine, so the whole horizon trajectory is
    one ``associative_scan`` over ``(a, b)`` pairs with no segment fallback.
    Reassociating float sums is NOT bit-stable, so the device core only uses
    this form under its decision-equality contract (``SCAN_MODE="assoc"``);
    the sequential folds stay the bit-parity path. Pass ``jnp.maximum`` to use
    it inside a jit trace.
    """
    a1, b1 = x
    a2, b2 = y
    return a1 + a2, maximum(b1 + a2, b2)
