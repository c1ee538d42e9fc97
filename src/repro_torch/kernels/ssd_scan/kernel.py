"""SSD chunked-scan kernel: CUDA launch wrapper and its plain version.

``ssd_scan_bhsd`` runs the Mamba-2 SSD recurrence (state-space duality,
arXiv:2405.21060)

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t,   y_t = C_t . h_t

chunk by chunk, over kernel-layout operands: x (b, H, S, hd) in float32 or
bf16, dt (b, H, S) float32 (after the softplus), A (H,) float32 (negative),
B and C (b, S, ds) in x's dtype, shared by every head. It returns y in x's
dtype and the final state (b, H, hd, ds) in float32. It replaces the Pallas
kernel of the same name in the JAX package; the CUDA source is
``repro_torch/csrc/ssd_scan.cu``.

Both versions compute what the TPU kernel computes, in float32 from widened
inputs, per chunk of ``Q = min(chunk, S)`` rows: ``cum = cumsum(dt A)``
(summed in float64 and rounded to float32: a float32 sum's rounding depends
on its order, and the decays amplify it, by up to 7e-3 in a y of 156 at
S = 300 with ``tests/test_kernels.py``'s inputs, so both versions sum
exactly and agree on ``cum``); the
scores ``C B^T`` times the decay ``exp(cum_q - cum_s)``, masked to ``s <= q``
before the exp (``NEG_INF = -2e38``), times ``dt_s``, then times x; plus the
carried state's part ``exp(cum) C h^T``; then the state update
``h = exp(total) h + (x dt exp(total - cum))^T B``. S need not be a multiple
of Q: the plain version zero-pads the tail chunk, as the reference's
``ops.py`` does, and the kernel masks the rows past S, which is the same
computation (dt = 0 there).

The kernel reads strided views with a contiguous last dimension (dt: any
strides), so the model's (b, S, H, hd) tensors and the B and C slices of its
projection pass in without copies, and ``out`` may be such a view too. A
prompt of one chunk of at most 64 rows (the serving prefill) is one launch
with no workspace; a longer one runs its chunks in parallel in three
launches over a float32 workspace of every chunk's state (``ssd_route``,
``work_floats``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -2.0e38
MAX_CHUNK = 128
SINGLE_MAX_ROWS = 64  # the longest one-chunk prompt that takes one launch
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 128):
    """The chunked SSD of the module docstring on any device, one chunk at a
    time over every (batch, head). Returns (y (b, H, S, hd) in x's dtype,
    final state (b, H, hd, ds) float32)."""
    b, H, S, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        dtf = F.pad(dtf, (0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    a = A.float()[None, :, None]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((b, H, hd, ds), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S + pad, Q):
        xc = xf[:, :, c0:c0 + Q]                    # (b, H, Q, hd)
        dtc = dtf[:, :, c0:c0 + Q]                  # (b, H, Q)
        bc = Bf[:, c0:c0 + Q]                       # (b, Q, ds)
        cc = Cf[:, c0:c0 + Q]
        cum = torch.cumsum((dtc * a).double(), dim=-1).float()
        total = cum[..., -1:]
        seg = cum[..., :, None] - cum[..., None, :]
        L = torch.exp(torch.where(causal, seg, NEG_INF))
        scores = (cc @ bc.transpose(1, 2))[:, None] * L * dtc[..., None, :]
        yc = scores @ xc
        yc = yc + (cc[:, None] @ h.transpose(2, 3)) * torch.exp(cum)[..., None]
        w = dtc * torch.exp(total - cum)
        h = h * torch.exp(total)[..., None] \
            + (xc * w[..., None]).transpose(2, 3) @ bc[:, None]
        ys.append(yc)
    y = torch.cat(ys, dim=2)[:, :, :S]
    return y.to(x.dtype), h


def ssd_route(S: int, chunk: int = 128) -> str:
    """How the kernel runs a prompt of S rows (mirrors ``single_chunk`` in
    the CUDA source): ``"single"``, one launch straight from the chunk, when
    the prompt is one chunk of at most ``SINGLE_MAX_ROWS`` rows; else
    ``"chunked"``, three launches (chunk states, the carry over chunks, the
    outputs) over a workspace."""
    Q = min(chunk, S)
    return "single" if S <= Q <= SINGLE_MAX_ROWS else "chunked"


def work_floats(b: int, H: int, S: int, hd: int, ds: int,
                chunk: int = 128) -> int:
    """Floats of the kernel's workspace (mirrors ``ssd_scan_work_floats``):
    none on the single route, else every chunk's (hd, ds) state and total
    decay per (batch, head)."""
    if ssd_route(S, chunk) == "single":
        return 0
    nch = -(-S // min(chunk, S))
    return b * nch * H * hd * ds + b * H * nch


def _check(x, dt, A, B, C, out, Q):
    if x.dtype not in _SUFFIX:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("B", B), ("C", C), ("out", out)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} must have x's dtype {x.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C), ("out", out)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t, nd in (("x", x, 4), ("B", B, 3), ("C", C, 3),
                        ("out", out, 4)):
        if t.dim() != nd or t.stride(-1) != 1:
            raise ValueError(f"{name} must be a {nd}-d tensor with a "
                             f"contiguous last dimension, got "
                             f"{tuple(t.shape)} strides "
                             f"{t.stride()}")
    b, H, S, hd = x.shape
    ds = B.shape[-1]
    if tuple(dt.shape) != (b, H, S) or tuple(A.shape) != (H,) \
            or not A.is_contiguous() or tuple(B.shape) != (b, S, ds) \
            or C.shape != B.shape or out.shape != x.shape:
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} A "
                         f"{tuple(A.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)} out {tuple(out.shape)}")
    if S < 1 or not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"need S >= 1 and 1 <= min(chunk, S) <= {MAX_CHUNK}, "
                         f"got S={S} Q={Q}")


def ssd_scan_bhsd(x, dt, A, B, C, *, chunk: int = 128, out=None):
    """The SSD scan of ``x`` (b, H, S, hd); see the module docstring.
    Returns (y, final state); y is ``out`` when given.

    CPU tensors take the plain version; CUDA tensors launch
    ``ssd_scan_{f32,bf16}`` (one kernel on the single route, three on the
    chunked one: one call, one count) or raise."""
    if x.device.type == "cpu":
        y, state = ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
        return (y if out is None else out.copy_(y)), state
    _build.refuse_grad("ssd_scan", x, dt, A, B, C)
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    b, H, S, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, S)
    _check(x, dt, A, B, C, out, Q)
    state = torch.empty((b, H, hd, ds), dtype=torch.float32, device=x.device)
    nw = work_floats(b, H, S, hd, ds, chunk)
    work = torch.empty(nw, dtype=torch.float32, device=x.device) if nw \
        else None
    vals = [*x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
            *out.stride()[:3]]
    P, I32 = _build.P, _build.I32
    fn = _build.function("ssd_scan", f"ssd_scan_{_SUFFIX[x.dtype]}",
                         [P] * 8 + [I32] * 6 + [P, P])
    rc = fn(_build.ptr(x), _build.ptr(dt), _build.ptr(A), _build.ptr(B),
            _build.ptr(C), _build.ptr(out), _build.ptr(state), _build.ptr(work),
            b, H, S, hd, ds,
            Q, (ctypes.c_longlong * len(vals))(*vals), _build.stream_of(x))
    _build.check(rc, "ssd_scan")
    _build.counted(ssd_scan_bhsd)
    return out, state


ssd_scan_bhsd.launches = 0
