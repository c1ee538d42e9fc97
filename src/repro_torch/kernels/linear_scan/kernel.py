"""Linear-scan kernel: CUDA launch wrapper and its plain version.

``linear_scan_bsd`` computes ``h_t = a_t * h_{t-1} + x_t`` over (B, S, D)
from ``h_{-1} = 0`` and returns ``(h, final_state)``; ``a=None`` means
``a == 1`` (a running sum). It replaces the Pallas kernel of the same name in
the JAX package; the CUDA source is ``repro_torch/csrc/linear_scan.cu``
(float32 and float64, one thread per (b, d) channel, sequential over S). The
plain version steps through S with one rounded multiply and one rounded add
per step, exactly like the kernel, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


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
    ``linear_scan_{f32,f64}`` or raise."""
    if x.device.type == "cpu":
        return linear_scan_plain(x, a)
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
    sfx = "f64" if x.dtype == torch.float64 else "f32"
    P, I32 = _build.P, _build.I32
    fn = _build.function("linear_scan", f"linear_scan_{sfx}",
                         [P] * 4 + [I32] * 3 + [P])
    rc = fn(_build.ptr(x), _build.ptr(a), _build.ptr(y), _build.ptr(state),
            B, S, D, _build.stream_of(x))
    _build.check(rc, "linear_scan")
    _build.counted(linear_scan_bsd)
    return y, state


linear_scan_bsd.launches = 0
