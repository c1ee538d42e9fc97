"""GBRT ensemble kernels: CUDA launch wrappers and their plain versions.

``gbrt_predict_multi`` (every cloud config's ensemble in one launch, the
Predictor's compute column) and ``gbrt_predict_blocked`` (one ensemble over
``(N, F)`` feature rows) replace the Pallas kernels of the same names in the
JAX package. The CUDA source is ``repro_torch/csrc/gbrt_predict.cu``; both
kernels are built for float32 and float64 and walk complete heap-layout trees
(+inf, or +3e38 in float32, marks a pass-through node) with ``acc = acc +
lr * leaf`` per tree from ``base``. The plain versions below compute the same
walk with torch ops, one rounded multiply and one rounded add per tree, so
in float64 kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_FLOATS = (torch.float32, torch.float64)


def _suffix(dtype) -> str:
    if dtype not in _FLOATS:
        raise TypeError(f"GBRT kernels take float32 or float64, got {dtype}")
    return "f64" if dtype == torch.float64 else "f32"


def _require(t, name, dtype, device, ndim):
    if t.dtype != dtype or t.device != device or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


# ------------------------------------------------------------- plain versions
def gbrt_predict_multi_plain(x, mem, lr, base, features, thresholds, leaves, *,
                             depth: int):
    """All configs' ensembles over the shared size column ``x`` (N,): config
    ``c`` walks its trees on the feature pair ``(x, mem[c])``. ``features``/
    ``thresholds``: (C, T, I); ``leaves``: (C, T, L); ``mem``/``lr``/``base``:
    (C,). Returns (N, C)."""
    N = x.shape[0]
    C, T, _ = features.shape
    feats = features.long()
    cidx = torch.arange(C, device=x.device)[None, :].expand(N, C)
    x0 = x[:, None].expand(N, C)
    x1 = mem[None, :].expand(N, C)
    first = 2 ** depth - 1
    acc = base[None, :].expand(N, C).clone()
    for t in range(T):
        node = torch.zeros((N, C), dtype=torch.long, device=x.device)
        for _ in range(depth):
            v = torch.where(feats[cidx, t, node] == 0, x0, x1)
            node = 2 * node + 1 + (v > thresholds[cidx, t, node]).long()
        acc = acc + lr[None, :] * leaves[cidx, t, node - first]
    return acc


def gbrt_predict_blocked_plain(x, features, thresholds, leaves, *, depth: int,
                               lr: float, base: float):
    """One ensemble over ``x`` (N, F). ``features``/``thresholds``: (T, I);
    ``leaves``: (T, L). Returns (N,)."""
    N = x.shape[0]
    feats = features.long()
    rows = torch.arange(N, device=x.device)
    first = 2 ** depth - 1
    acc = torch.full((N,), base, dtype=x.dtype, device=x.device)
    for t in range(feats.shape[0]):
        node = torch.zeros(N, dtype=torch.long, device=x.device)
        for _ in range(depth):
            v = x[rows, feats[t][node]]
            node = 2 * node + 1 + (v > thresholds[t][node]).long()
        acc = acc + lr * leaves[t][node - first]
    return acc


# ------------------------------------------------------------ CUDA wrappers
def gbrt_predict_multi(x, mem, lr, base, features, thresholds, leaves, *,
                       depth: int):
    """(N, C) predictions of every config's ensemble; see the plain version.

    CPU tensors take the plain version; CUDA tensors launch
    ``gbrt_multi_{f32,f64}`` (one block per (config, 256 rows), the config's
    ensemble in shared memory) or raise."""
    if x.device.type == "cpu":
        return gbrt_predict_multi_plain(x, mem, lr, base, features, thresholds,
                                        leaves, depth=depth)
    dtype, device = x.dtype, x.device
    sfx = _suffix(dtype)
    C, T, I = features.shape
    L = leaves.shape[2]
    if I != 2 ** depth - 1 or L != 2 ** depth:
        raise ValueError(f"depth {depth} needs I={2 ** depth - 1}, "
                         f"L={2 ** depth}; got I={I}, L={L}")
    _require(x, "x", dtype, device, 1)
    for name, t, nd in (("mem", mem, 1), ("lr", lr, 1), ("base", base, 1),
                        ("thresholds", thresholds, 3), ("leaves", leaves, 3)):
        _require(t, name, dtype, device, nd)
    _require(features, "features", torch.int32, device, 3)
    N = x.shape[0]
    out = torch.empty((N, C), dtype=dtype, device=device)
    P, I32 = _build.P, _build.I32
    fn = _build.function("gbrt_predict", f"gbrt_multi_{sfx}",
                         [P] * 8 + [I32] * 6 + [P])
    rc = fn(*(_build.ptr(t) for t in (x, mem, lr, base, features, thresholds,
                                      leaves, out)),
            N, C, T, I, L, depth, _build.stream_of(x))
    _build.check(rc, "gbrt_predict_multi")
    _build.counted(gbrt_predict_multi)
    return out


gbrt_predict_multi.launches = 0


def gbrt_predict_blocked(x, features, thresholds, leaves, *, depth: int,
                         lr: float, base: float):
    """(N,) predictions of one ensemble over ``x`` (N, F); see the plain
    version. CPU tensors take the plain version; CUDA tensors launch
    ``gbrt_blocked_{f32,f64}`` or raise."""
    if x.device.type == "cpu":
        return gbrt_predict_blocked_plain(x, features, thresholds, leaves,
                                          depth=depth, lr=lr, base=base)
    dtype, device = x.dtype, x.device
    sfx = _suffix(dtype)
    T, I = features.shape
    L = leaves.shape[1]
    if I != 2 ** depth - 1 or L != 2 ** depth:
        raise ValueError(f"depth {depth} needs I={2 ** depth - 1}, "
                         f"L={2 ** depth}; got I={I}, L={L}")
    _require(x, "x", dtype, device, 2)
    _require(thresholds, "thresholds", dtype, device, 2)
    _require(leaves, "leaves", dtype, device, 2)
    _require(features, "features", torch.int32, device, 2)
    N, F = x.shape
    out = torch.empty(N, dtype=dtype, device=device)
    P, I32, F64 = _build.P, _build.I32, _build.F64
    fn = _build.function("gbrt_predict", f"gbrt_blocked_{sfx}",
                         [P] * 5 + [I32] * 6 + [F64, F64, P])
    rc = fn(*(_build.ptr(t) for t in (x, features, thresholds, leaves, out)),
            N, F, T, I, L, depth, float(lr), float(base), _build.stream_of(x))
    _build.check(rc, "gbrt_predict_blocked")
    _build.counted(gbrt_predict_blocked)
    return out


gbrt_predict_blocked.launches = 0
