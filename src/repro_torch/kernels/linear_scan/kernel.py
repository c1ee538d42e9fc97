"""Linear-scan kernel: CUDA launch wrapper and its plain version.

``linear_scan_bsd`` computes ``h_t = a_t * h_{t-1} + x_t`` over (B, S, D)
from ``h_{-1} = 0`` and returns ``(h, final_state)``; ``a=None`` means
``a == 1`` (a running sum). It replaces the Pallas kernel of the same name in
the JAX package; the CUDA source is ``repro_torch/csrc/linear_scan.cu``.

The wrapper picks one of two regimes from the dtype and from whether ``a``
is given, never from the shape (``scan_regime``):

- ``"fold"`` (float64, or ``a=None``): the exact left fold, one rounded
  multiply and one rounded add per step, bit for bit like the plain version
  (and so like ``np.cumsum``); the placement core's surplus prefix runs here.
- ``"chunked"`` (float32 with ``a``): the RG-LRU regime, a chunked scan over
  S in chunks of ``CHUNK_ROWS`` rows, within 5e-5 of the plain version.

The plain version steps through S with one rounded multiply and one rounded
add per step.

The chunked regime has a backward, K3b (``linear_scan_bwd_bsd``, its plain
version ``linear_scan_bwd_plain``): from the cotangents ``dh`` of h and
``dfinal`` of the final state it folds ``g_t = dh_t + a_{t+1} g_{t+1}``
backwards from ``g_{S-1} = dh_{S-1} + dfinal`` and gives ``dx_t = g_t`` and
``da_t = g_t h_{t-1}`` (``h_{-1} = 0``). ``ops.LinearScanFn`` puts K3 and K3b
on the two sides of autograd; the fold regime has no backward on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, flops

CHUNK_ROWS = 128  # rows per chunk of the chunked regime


def scan_regime(x: torch.Tensor, a: torch.Tensor | None) -> str:
    """``"chunked"`` for a gated float32 scan, else ``"fold"``: read from the
    dtype and from ``a`` alone, so the route never depends on the shape."""
    return "chunked" if a is not None and x.dtype == torch.float32 else "fold"


def linear_scan_plain(x: torch.Tensor, a: torch.Tensor | None = None):
    """Sequential fold over S on any device. Returns (h (B,S,D), (B,D))."""
    B, S, D = x.shape
    y = torch.empty_like(x)
    h = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    for t in range(S):
        h = h + x[:, t] if a is None else a[:, t] * h + x[:, t]
        y[:, t] = h
    return y, h


def linear_scan_bsd(x: torch.Tensor, a: torch.Tensor | None = None):
    """``(h, final_state)`` of the gated recurrence; see the module docstring.

    CPU tensors take the plain version; CUDA tensors launch
    ``linear_scan_fold_{f32,f64}`` or ``linear_scan_chunked_f32`` (by
    ``scan_regime``) or raise. Where autograd needs a gradient through a
    chunked call on the card it goes through ``ops.LinearScanFn`` (forward
    K3, backward K3b); the fold regime refuses it. In a
    ``kernels.counting`` block, fake or meta tensors run nothing: the call
    is counted and empty outputs returned."""
    if _build.abstract(x, a):
        B, S, D = x.shape
        _build.count("linear_scan", *flops.linear_scan(B, S, D,
                                                       a is not None))
        return torch.empty_like(x), torch.empty((B, D), dtype=x.dtype,
                                                device=x.device)
    if x.device.type == "cpu":
        return linear_scan_plain(x, a)
    if scan_regime(x, a) == "chunked" and _build.needs_grad(x, a):
        from repro_torch.kernels.linear_scan.ops import LinearScanFn

        return LinearScanFn.apply(x, a)
    _build.refuse_grad("linear_scan", x, a)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"linear_scan takes float32 or float64, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, S, D) tensor, got "
                         f"{tuple(x.shape)}")
    if a is not None and (a.shape != x.shape or a.dtype != x.dtype
                          or a.device != x.device or not a.is_contiguous()):
        raise ValueError("a must match x in shape, dtype, device and be "
                         "contiguous")
    B, S, D = x.shape
    y = torch.empty_like(x)
    state = torch.empty((B, D), dtype=x.dtype, device=x.device)
    P, I32 = _build.P, _build.I32
    if scan_regime(x, a) == "fold":
        sfx = "f64" if x.dtype == torch.float64 else "f32"
        fn = _build.function("linear_scan", f"linear_scan_fold_{sfx}",
                             [P] * 4 + [I32] * 3 + [P])
        rc = fn(_build.ptr(x), _build.ptr(a), _build.ptr(y),
                _build.ptr(state), B, S, D, _build.stream_of(x))
    else:
        n_chunks = max(1, -(-S // CHUNK_ROWS))
        summary = torch.empty((2, B, n_chunks, D), dtype=x.dtype,
                              device=x.device)
        fn = _build.function("linear_scan", "linear_scan_chunked_f32",
                             [P] * 5 + [I32] * 4 + [P])
        rc = fn(_build.ptr(x), _build.ptr(a), _build.ptr(y),
                _build.ptr(state), _build.ptr(summary), B, S, D, CHUNK_ROWS,
                _build.stream_of(x))
    _build.check(rc, "linear_scan")
    _build.counted(linear_scan_bsd)
    return y, state


linear_scan_bsd.launches = 0


def linear_scan_bwd_plain(dh, dfinal, a, h):
    """The gradient of the gated scan as a fold backwards over S, on any
    device: ``g = carry + dh_t``, ``dx_t = g``, ``da_t = g * h_{t-1}``, then
    ``carry = a_t * g``, from ``carry = dfinal`` (zero when None). ``dh``,
    ``a`` and the forward's ``h`` are (B, S, D). Returns (dx, da)."""
    B, S, D = h.shape
    dx = torch.empty_like(h)
    da = torch.empty_like(h)
    carry = torch.zeros((B, D), dtype=h.dtype, device=h.device) \
        if dfinal is None else dfinal
    for t in range(S - 1, -1, -1):
        g = carry + dh[:, t]
        dx[:, t] = g
        da[:, t] = g * h[:, t - 1] if t else 0.0
        carry = a[:, t] * g
    return dx, da


def linear_scan_bwd_bsd(dh, dfinal, a, h, *, tally=None):
    """K3b: (dx, da) of the chunked scan for the cotangents ``dh`` (B, S, D)
    and ``dfinal`` (B, D) or None, from the forward's ``a`` and its output
    ``h``; see the module docstring.

    CPU tensors take the plain version; CUDA tensors launch
    ``linear_scan_chunked_bwd_f32`` (two passes: one call, one count) or
    raise. The launch is counted in ``tally`` when given (``LinearScanFn``
    passes the ``recording`` tally open where its forward ran), else in the
    calling thread's. In a ``kernels.counting`` block, fake or meta
    tensors run nothing: the call is counted and empty outputs returned."""
    if _build.abstract(dh, a, h):
        _build.count("linear_scan_bwd", *flops.linear_scan_bwd(*h.shape))
        return torch.empty_like(h), torch.empty_like(h)
    if h.device.type == "cpu":
        return linear_scan_bwd_plain(dh, dfinal, a, h)
    _build.refuse_grad("linear_scan_bwd", dh, dfinal, a, h)
    for name, t in (("dh", dh), ("a", a), ("h", h)):
        if t.dtype != torch.float32 or t.dim() != 3 \
                or t.shape != h.shape or t.device != h.device \
                or not t.is_contiguous():
            raise ValueError(f"linear_scan_bwd: {name} must be a contiguous "
                             f"float32 (B, S, D) tensor like h on "
                             f"{h.device}, got {t.dtype} {tuple(t.shape)}")
    B, S, D = h.shape
    if dfinal is not None and (dfinal.dtype != torch.float32
                               or dfinal.shape != (B, D)
                               or dfinal.device != h.device
                               or not dfinal.is_contiguous()):
        raise ValueError(f"linear_scan_bwd: dfinal must be a contiguous "
                         f"float32 ({B}, {D}) tensor, got {dfinal.dtype} "
                         f"{tuple(dfinal.shape)}")
    dx = torch.empty_like(h)
    da = torch.empty_like(h)
    n_chunks = max(1, -(-S // CHUNK_ROWS))
    summary = torch.empty((2, B, n_chunks, D), dtype=h.dtype, device=h.device)
    P, I32 = _build.P, _build.I32
    fn = _build.function("linear_scan", "linear_scan_chunked_bwd_f32",
                         [P] * 7 + [I32] * 4 + [P])
    rc = fn(_build.ptr(dh), _build.ptr(dfinal), _build.ptr(a), _build.ptr(h),
            _build.ptr(dx), _build.ptr(da), _build.ptr(summary), B, S, D,
            CHUNK_ROWS, _build.stream_of(h))
    _build.check(rc, "linear_scan_bwd")
    _build.counted(linear_scan_bwd_bsd, tally)
    return dx, da


linear_scan_bwd_bsd.launches = 0
