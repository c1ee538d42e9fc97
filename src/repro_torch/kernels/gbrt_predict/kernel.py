"""GBRT ensemble kernels: CUDA launch wrappers and their plain versions.

``gbrt_predict_multi`` (K1: every cloud config's ensemble in one call, the
Predictor's compute column) and ``gbrt_predict_blocked`` (K2: one ensemble
over ``(N, F)`` feature rows) replace the Pallas kernels of the same names in
the JAX package. Trees are complete heaps (+inf, or +3e38 in float32, marks a
pass-through node) summed as ``acc = acc + lr * leaf`` per tree from
``base``. The plain versions below walk every tree with torch ops, one
rounded multiply and one rounded add per tree.

The CUDA source ``repro_torch/csrc/gbrt_predict.cu`` builds a step table on
the card on every call and then looks each row up in it: the ensemble is
evaluated once per entry (one warp each, at a representative of each run of
sizes between consecutive thresholds), and a row costs one binary search
per searched feature; the lookup is launched as the build's programmatic
dependent, so it searches while the build runs. The source's note gives
the argument that this is the walk's result bit for bit. The table's
layout (``StepTable``: the breaks, their counts, K2's cells, radix and
route) depends on the model alone: ``ops`` makes it once per model and
records it against the operands' thresholds tensor, where the wrappers
look it up. K2 takes the table while it has at most ``TABLE_FEATURES``
feature ids and at most ``TABLE_CELLS`` cells; otherwise it runs a walk
kernel, one thread per row (``blocked_route``). A model with a feature id
at or past ``F`` is rejected, as the reference's numpy walk does. Both are
built for float32 and float64.
"""

from __future__ import annotations

import ctypes
import math
import weakref

import torch

from repro_torch.kernels import _build

_FLOATS = (torch.float32, torch.float64)
# K2's table route: at most this many cells (the product over feature ids of
# break count + 1) and feature ids (``kMaxTableFeatures`` in the source)
TABLE_CELLS = 4096
TABLE_FEATURES = 16


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
    ``leaves``: (T, L). Returns (N,). Raises ValueError if a feature id is
    at or past F."""
    N, F = x.shape
    feats = features.long()
    if feats.numel() and int(feats.max()) >= F:
        raise ValueError(f"feature id {int(feats.max())} past x's {F} "
                         f"columns")
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


# ----------------------------------------------------------- step tables
def blocked_route(counts) -> str:
    """K2's route for a model whose feature ids ``0 .. len(counts) - 1``
    have ``counts`` breaks: ``"table"`` or ``"walk"``."""
    fits = len(counts) <= TABLE_FEATURES
    return "table" if fits and _cells(counts) <= TABLE_CELLS else "walk"


def _cells(counts) -> int:
    return math.prod(n + 1 for n in counts)


class StepTable:
    """A model's step-table layout, the same on every call: ``breaks``
    (n, W) on the operands' device, row ``i`` (K1: config ``i``'s feature
    0; K2: feature id ``i``) its sorted distinct thresholds, NaN and +inf
    left out, padded with +inf, ``W`` at least one more than the longest;
    ``counts`` their lengths (host ints); and K2's ``cells``, ``route`` and
    ``radix`` (break count + 1 per feature id, a host array the table
    launch reads)."""

    def __init__(self, breaks, counts):
        self.breaks = breaks
        self.counts = tuple(int(n) for n in counts)
        self.cells = _cells(self.counts)
        self.route = blocked_route(self.counts)
        self._radix = (ctypes.c_int * len(self.counts))(
            *(n + 1 for n in self.counts))
        self.radix_ptr = ctypes.addressof(self._radix)


# id(thresholds) -> (weakref to it, its _version then, StepTable); an entry
# leaves with its tensor
_STEP_TABLES: dict[int, tuple] = {}


def record_step_table(thresholds, breaks, counts) -> None:
    """Record the step table of the operand set whose thresholds tensor is
    ``thresholds`` (``ops`` does, as it hosts a model's operands)."""
    key = id(thresholds)
    ref = weakref.ref(thresholds, lambda _: _STEP_TABLES.pop(key, None))
    _STEP_TABLES[key] = (ref, thresholds._version, StepTable(breaks, counts))


def step_table(thresholds) -> StepTable:
    """The ``StepTable`` recorded against ``thresholds``; raises ValueError
    if none was, or if the tensor changed in place since."""
    hit = _STEP_TABLES.get(id(thresholds))
    if hit is None or hit[0]() is not thresholds \
            or hit[1] != thresholds._version:
        raise ValueError(
            "thresholds: no step table is recorded for this tensor as it is "
            "(ops.kernel_operands / ops.multi_kernel_operands record one)")
    return hit[2]


# ------------------------------------------------------------ CUDA wrappers
def _check_tree_shape(depth, I, L):
    if I != 2 ** depth - 1 or L != 2 ** depth:
        raise ValueError(f"depth {depth} needs I={2 ** depth - 1}, "
                         f"L={2 ** depth}; got I={I}, L={L}")


def gbrt_predict_multi(x, mem, lr, base, features, thresholds, leaves, *,
                       depth: int):
    """(N, C) predictions of every config's ensemble; see the plain version.

    CPU tensors take the plain version; CUDA tensors launch
    ``gbrt_multi_{f32,f64}`` (a build of the (C, W) step table of
    ``step_table(thresholds)``, one warp per entry, then a lookup, one
    thread per row) or raise."""
    if x.device.type == "cpu":
        return gbrt_predict_multi_plain(x, mem, lr, base, features, thresholds,
                                        leaves, depth=depth)
    _build.refuse_grad("gbrt_predict_multi", x, mem, lr, base, thresholds,
                       leaves)
    dtype, device = x.dtype, x.device
    sfx = _suffix(dtype)
    C, T, I = features.shape
    L = leaves.shape[2]
    _check_tree_shape(depth, I, L)
    _require(x, "x", dtype, device, 1)
    for name, t, nd in (("mem", mem, 1), ("lr", lr, 1), ("base", base, 1),
                        ("thresholds", thresholds, 3), ("leaves", leaves, 3)):
        _require(t, name, dtype, device, nd)
    _require(features, "features", torch.int32, device, 3)
    breaks = step_table(thresholds).breaks
    N, W = x.shape[0], breaks.shape[1]
    if N == 0:
        return torch.empty((0, C), dtype=dtype, device=device)
    # one allocation: the (C, W) table fills the W rows after the output's N
    buf = torch.empty((N + W, C), dtype=dtype, device=device)
    out = buf[:N]
    P, I32 = _build.P, _build.I32
    fn = _build.function("gbrt_predict", f"gbrt_multi_{sfx}",
                         [P] * 10 + [I32] * 7 + [P])
    rc = fn(*(_build.ptr(t) for t in (x, mem, lr, base, features, thresholds,
                                      leaves, breaks)),
            buf.data_ptr() + N * C * buf.element_size(), buf.data_ptr(),
            N, C, T, I, L, depth, W, _build.stream_of(x))
    _build.check(rc, "gbrt_predict_multi")
    _build.counted(gbrt_predict_multi)
    return out


gbrt_predict_multi.launches = 0


def gbrt_predict_blocked(x, features, thresholds, leaves, *, depth: int,
                         lr: float, base: float):
    """(N,) predictions of one ensemble over ``x`` (N, F); see the plain
    version. CPU tensors take the plain version; CUDA tensors launch, by
    the route of ``step_table(thresholds)``, ``gbrt_blocked_table_{f32,f64}``
    (a build of the step table over the product of the features' break
    counts + 1, then a lookup) or ``gbrt_blocked_walk_{f32,f64}``, or
    raise (ValueError
    for a feature id at or past F). ``gbrt_predict_blocked.routes`` counts
    the launches of each route."""
    if x.device.type == "cpu":
        return gbrt_predict_blocked_plain(x, features, thresholds, leaves,
                                          depth=depth, lr=lr, base=base)
    _build.refuse_grad("gbrt_predict_blocked", x, thresholds, leaves)
    dtype, device = x.dtype, x.device
    sfx = _suffix(dtype)
    T, I = features.shape
    L = leaves.shape[1]
    _check_tree_shape(depth, I, L)
    _require(x, "x", dtype, device, 2)
    _require(thresholds, "thresholds", dtype, device, 2)
    _require(leaves, "leaves", dtype, device, 2)
    _require(features, "features", torch.int32, device, 2)
    tab = step_table(thresholds)
    n_ids = len(tab.counts)
    N, F = x.shape
    if n_ids > F:
        raise ValueError(f"feature id {n_ids - 1} past x's {F} columns")
    if N == 0:
        return torch.empty(0, dtype=dtype, device=device)
    P, I32, F64 = _build.P, _build.I32, _build.F64
    if tab.route == "table":
        # one allocation: the table's cells follow the output's N
        buf = torch.empty(N + tab.cells, dtype=dtype, device=device)
        out = buf[:N]
        fn = _build.function("gbrt_predict", f"gbrt_blocked_table_{sfx}",
                             [P] * 6 + [I32] * 2 + [P] * 2 + [I32] * 6
                             + [F64, F64, P])
        rc = fn(*(_build.ptr(t) for t in (x, features, thresholds, leaves,
                                          tab.breaks)),
                tab.radix_ptr, n_ids, tab.breaks.shape[1],
                buf.data_ptr() + N * buf.element_size(), buf.data_ptr(), N, F,
                T, I, L, depth, float(lr), float(base), _build.stream_of(x))
    else:
        out = torch.empty(N, dtype=dtype, device=device)
        fn = _build.function("gbrt_predict", f"gbrt_blocked_walk_{sfx}",
                             [P] * 5 + [I32] * 6 + [F64, F64, P])
        rc = fn(*(_build.ptr(t) for t in (x, features, thresholds, leaves,
                                          out)),
                N, F, T, I, L, depth, float(lr), float(base),
                _build.stream_of(x))
    _build.check(rc, f"gbrt_predict_blocked ({tab.route})")
    _build.counted(gbrt_predict_blocked)
    gbrt_predict_blocked.routes[tab.route] += 1
    return out


gbrt_predict_blocked.launches = 0
gbrt_predict_blocked.routes = {"table": 0, "walk": 0}
