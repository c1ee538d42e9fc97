"""Operand preparation for the GBRT kernels, and ``gbrt_predict(model, x)``.

The ensemble arrays of a fitted ``repro_torch.core.gbrt.GBRT`` are hosted on
a device once per (model identity, dtype, device), with a weakref guard: a
refit swaps in a fresh model object, whose fresh id misses the cache, and a
recycled id is caught before stale operands are served. So a streaming
serve does no per-chunk operand preparation.

Beside the ensemble arrays, each operand set's step-table layout
(``kernel.StepTable``) is made here and recorded against its thresholds
tensor, where the CUDA wrappers look it up: per searched feature the sorted
distinct thresholds in the operand dtype (float32 ones after the +-3e38
clip, where rounding can merge two float64 thresholds), NaN and +inf left
out. It depends on the thresholds alone, so it lives as long as they do;
the step tables' values (from ``mem``, ``lr``, ``base`` and the leaves) are
built by the kernels on every call.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from repro_torch.kernels.gbrt_predict.kernel import (
    gbrt_predict_blocked,
    gbrt_predict_multi,
    record_step_table,
)

_OPERANDS: dict[tuple, tuple] = {}
_MULTI_OPERANDS: dict[tuple, tuple] = {}
_OPERAND_LOCK = threading.Lock()
F32_BIG = 3.0e38


def _cached(cache: dict, key, models, build):
    """The operands cached under ``key``, built once. The build runs under
    the lock, so threads that serve one model at once (sharded runtimes)
    share one operand set, and ``_STEP_TABLES`` is written under it."""
    with _OPERAND_LOCK:
        hit = cache.get(key)
        if hit is not None:
            refs, val = hit
            if all(r() is m for r, m in zip(refs, models)):
                return val
            cache.pop(key, None)  # id recycled by a swap: stale
        val = build()
        try:
            refs = tuple(weakref.ref(m) for m in models)
        except TypeError:
            return val  # non-weakrefable model: serve uncached
        if len(cache) > 128:  # drop entries whose model is gone
            for k in [k for k, (rs, _) in cache.items()
                      if any(r() is None for r in rs)]:
                cache.pop(k, None)
        cache[key] = (refs, val)
    return val


def _thresholds(model, dtype) -> np.ndarray:
    """+inf pass-through thresholds stay +inf in float64; float32 compares
    need them finite, so they are clipped to +-3e38 (as the TPU kernel
    does)."""
    thr = np.asarray(model.thresholds, np.float64)
    if dtype == torch.float32:
        return np.clip(thr, -F32_BIG, F32_BIG).astype(np.float32)
    return thr


def step_breaks(groups, npd) -> tuple[np.ndarray, tuple[int, ...]]:
    """``(breaks (len(groups), W), counts)``: each group's sorted distinct
    thresholds of dtype ``npd``, NaN and +inf left out (a node whose
    threshold is either sends every row left), padded with +inf to
    ``W = max(counts) + 1``."""
    rows = []
    for th in groups:
        th = np.asarray(th, npd)
        rows.append(np.unique(th[~np.isnan(th) & (th != np.inf)]))
    counts = tuple(int(r.shape[0]) for r in rows)
    out = np.full((len(rows), max(counts, default=0) + 1), np.inf, npd)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out, counts


def kernel_operands(model, dtype=torch.float64, device="cpu") -> tuple:
    """``(features int32 (T, I), thresholds (T, I), leaves (T, L))`` of one
    ensemble as tensors of ``dtype`` on ``device``, the thresholds carrying
    the step table (``step_breaks``) of feature ids ``0 .. max id``."""
    device = torch.device(device)
    npd = np.float64 if dtype == torch.float64 else np.float32

    def build():
        feats = np.asarray(model.features, np.int32)
        thr = _thresholds(model, dtype)
        n_ids = int(feats.max()) + 1 if feats.size else 1
        breaks, counts = step_breaks(
            [thr[feats == f] for f in range(n_ids)], npd)
        thr_t = torch.as_tensor(thr, device=device)
        record_step_table(thr_t, torch.as_tensor(breaks, device=device),
                          counts)
        return (torch.as_tensor(feats, device=device), thr_t,
                torch.as_tensor(np.asarray(model.leaves, npd), device=device))

    return _cached(_OPERANDS, (id(model), dtype, str(device)), (model,), build)


def multi_kernel_operands(models, dtype=torch.float64, device="cpu") -> tuple:
    """Stacked, padded operands for one ``gbrt_predict_multi`` launch.

    Every config's ensemble is padded to the common ``(T, I, L)`` of the
    deepest / longest one, staying exact per config:

    - extra trees are all-pass-through with zero leaves (``acc + lr * 0``
      leaves ``acc`` unchanged);
    - a depth-``d`` tree padded to depth ``dmax`` walks on through
      pass-through levels to the leftmost descendant, so leaf ``j`` sits at
      slot ``j << (dmax - d)``.

    Returns ``(features (C,T,I) int32, thresholds (C,T,I), leaves (C,T,L),
    lr (C,), base (C,), depth)`` as tensors of ``dtype`` on ``device``, the
    thresholds carrying the step table (``step_breaks``) of each config's
    feature-0 thresholds of the padded stack.
    """
    models = tuple(models)
    device = torch.device(device)
    npd = np.float64 if dtype == torch.float64 else np.float32

    def build():
        pad_thr = np.inf if dtype == torch.float64 else F32_BIG
        depths = [int(m.config.max_depth) for m in models]
        dmax = max(depths)
        tmax = max(int(np.asarray(m.features).shape[0]) for m in models)
        n_int, n_leaf = 2 ** dmax - 1, 2 ** dmax
        C = len(models)
        F = np.zeros((C, tmax, n_int), np.int32)
        TH = np.full((C, tmax, n_int), pad_thr, npd)
        LV = np.zeros((C, tmax, n_leaf), npd)
        LR = np.zeros(C, npd)
        BASE = np.zeros(C, npd)
        for c, m in enumerate(models):
            f = np.asarray(m.features, np.int32)
            t, i = f.shape
            F[c, :t, :i] = f
            TH[c, :t, :i] = _thresholds(m, dtype)
            LV[c, :t, ::1 << (dmax - depths[c])] = np.asarray(m.leaves, npd)
            LR[c] = m.config.learning_rate
            BASE[c] = m.base
        BR, counts = step_breaks([TH[c][F[c] == 0] for c in range(C)], npd)
        as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        th = as_t(TH)
        record_step_table(th, as_t(BR), counts)
        return as_t(F), th, as_t(LV), as_t(LR), as_t(BASE), dmax

    key = (tuple(id(m) for m in models), dtype, str(device))
    return _cached(_MULTI_OPERANDS, key, models, build)


def gbrt_predict(model, x: torch.Tensor) -> torch.Tensor:
    """Predict a fitted GBRT over ``x`` (N, F) (or (N,) for one feature) with
    ``gbrt_predict_blocked``, in ``x``'s dtype on ``x``'s device."""
    if x.dim() == 1:
        x = x[:, None]
    x = x.contiguous()
    feats, thr, lvs = kernel_operands(model, x.dtype, x.device)
    return gbrt_predict_blocked(
        x, feats, thr, lvs, depth=int(model.config.max_depth),
        lr=float(model.config.learning_rate), base=float(model.base))


def gbrt_predict_configs(models, mem: torch.Tensor,
                         sizes: torch.Tensor) -> torch.Tensor:
    """(N, C) predictions of config ``c``'s model at memory ``mem[c]`` (a (C,)
    tensor beside ``sizes``) over the size column ``sizes`` (N,), in one
    ``gbrt_predict_multi`` launch."""
    F, TH, LV, LR, BASE, depth = multi_kernel_operands(models, sizes.dtype,
                                                       sizes.device)
    return gbrt_predict_multi(sizes.contiguous(), mem.to(sizes.dtype), LR,
                              BASE, F, TH, LV, depth=depth)
