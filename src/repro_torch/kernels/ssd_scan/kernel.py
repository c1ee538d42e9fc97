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
``work_floats``); a caller that passes that workspace (``work=``) keeps in
it, after the call, the state entering each chunk.

The backward, K6b (``ssd_scan_bwd_bhsd``, CUDA source
``repro_torch/csrc/ssd_scan_bwd.cu``; its plain version
``ssd_scan_bwd_plain``), takes the cotangents ``dy`` of y and ``dstate`` of
the final state (zero when None) and gives (dx, ddt, dA, dB, dC) by explicit
formulas, chunk by chunk from the last, as Mamba-2's chunked backward does.
Per chunk, with ``L_qs = exp(cum_q - cum_s)`` for s <= q, ``W_qs = L_qs
dt_s``, ``e_s = exp(total - cum_s)``, h_prev / h_next the states entering
and leaving the chunk and dh_next the gradient of h_next (the later chunk's
dh_prev; the last chunk's is ``dstate``) (``ssd_chunk_grads``):

    dh_prev = exp(total) dh_next + sum_q exp(cum_q) dy_q (x) C_q
    dx_s    = sum_q (C_q.B_s) W_qs dy_q + e_s dt_s dh_next B_s
    dC_q    = sum_s (dy_q.x_s) W_qs B_s + exp(cum_q) h_prev^T dy_q
    dB_s    = sum_q (dy_q.x_s) W_qs C_q + e_s dt_s dh_next^T x_s

dB and dC summed over the heads (B and C are shared by all of them); dt's
direct part ``sum_q (dy_q.x_s)(C_q.B_s) L_qs + e_s x_s.(dh_next B_s)``, and
``dcum``, the gradient of cum through L, ``exp(cum_q)``, ``exp(total)`` and
``e_s``, reverse-summed within the chunk into ``da``, the gradient of ``dt
A``: ``ddt += A da``, ``dA = sum dt da``. The sums over the scores that
feed ``dcum`` and dt's direct part, ``dcum``'s reverse sum and dA run in
float64 (as cum is summed): the reverse sum cancels the terms that both a
row's and a column's sum hold, exactly in float64, where float32 would
leave their roundings behind (up to 1e-4 of a gradient at mamba2-780m's
widths); the rest runs in float32 from widened inputs. The kernel's bf16
route runs every product on the tensor cores, each float32 operand (the
decayed scores P and R, the states, ``exp(cum) dy``) split into three bf16
terms against the exact bf16 other operand, so its float32 gradients
(ddt, dA) agree with the plain version's to a few 1e-6 of their scale, and
keeps P and R in registers; its float32 route keeps them in its workspace
(``bwd_work_floats``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, flops

NEG_INF = -2.0e38
MAX_CHUNK = 128
SINGLE_MAX_ROWS = 64  # the longest one-chunk prompt that takes one launch
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _padded_chunks(t, Q, axis):
    """float32 ``t`` zero-padded along ``axis`` to a multiple of Q."""
    t = t.float()
    pad = (-t.shape[axis]) % Q
    if pad:
        widths = [0, 0] * (t.dim() - 1 - axis) + [0, pad]
        t = F.pad(t, widths)
    return t


def _states(xf, dtf, A, Bf, Q):
    """The plain version's state update over padded float32 chunks: the
    state entering each chunk (a list, chunk 0's zero) and the final
    state."""
    b, H, _, hd = xf.shape
    a = A.float()[None, :, None]
    h = torch.zeros((b, H, hd, Bf.shape[-1]), dtype=torch.float32,
                    device=xf.device)
    states = []
    for c0 in range(0, xf.shape[2], Q):
        states.append(h)
        xc, dtc = xf[:, :, c0:c0 + Q], dtf[:, :, c0:c0 + Q]
        cum = torch.cumsum((dtc * a).double(), dim=-1).float()
        total = cum[..., -1:]
        w = dtc * torch.exp(total - cum)
        h = h * torch.exp(total)[..., None] \
            + (xc * w[..., None]).transpose(2, 3) @ Bf[:, None, c0:c0 + Q]
    return states, h


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 128):
    """The chunked SSD of the module docstring on any device, one chunk at a
    time over every (batch, head). Returns (y (b, H, S, hd) in x's dtype,
    final state (b, H, hd, ds) float32)."""
    S = x.shape[2]
    Q = min(chunk, S)
    xf, dtf = _padded_chunks(x, Q, 2), _padded_chunks(dt, Q, 2)
    Bf, Cf = _padded_chunks(B, Q, 1), _padded_chunks(C, Q, 1)
    states, h = _states(xf, dtf, A, Bf, Q)
    a = A.float()[None, :, None]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c, c0 in enumerate(range(0, xf.shape[2], Q)):
        xc = xf[:, :, c0:c0 + Q]                    # (b, H, Q, hd)
        dtc = dtf[:, :, c0:c0 + Q]                  # (b, H, Q)
        bc = Bf[:, c0:c0 + Q]                       # (b, Q, ds)
        cc = Cf[:, c0:c0 + Q]
        cum = torch.cumsum((dtc * a).double(), dim=-1).float()
        seg = cum[..., :, None] - cum[..., None, :]
        L = torch.exp(torch.where(causal, seg, NEG_INF))
        scores = (cc @ bc.transpose(1, 2))[:, None] * L * dtc[..., None, :]
        yc = scores @ xc
        yc = yc + (cc[:, None] @ states[c].transpose(2, 3)) \
            * torch.exp(cum)[..., None]
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


def ssd_scan_bhsd(x, dt, A, B, C, *, chunk: int = 128, out=None,
                  work=None):
    """The SSD scan of ``x`` (b, H, S, hd); see the module docstring.
    Returns (y, final state); y is ``out`` when given. A given ``work``
    (float32, ``work_floats`` long, on the chunked route) is the kernel's
    workspace: after the call it holds the state entering each chunk
    ((b, nch, H, hd, ds) first), which K6b reads.

    CPU tensors take the plain version; CUDA tensors launch
    ``ssd_scan_{f32,bf16}`` (one kernel on the single route, three on the
    chunked one: one call, one count) or raise. Where autograd needs a
    gradient through the call on the card it goes through
    ``ops.SSDScanFn`` (forward K6, backward K6b), which writes no ``out``
    in place. In a ``kernels.counting`` block, fake or meta tensors run
    nothing: the call is counted and empty outputs (or ``out``)
    returned."""
    if _build.abstract(x, dt, A, B, C):
        b, H, S, hd = x.shape
        _build.count("ssd_scan", *flops.ssd(b, H, S, hd, B.shape[-1], chunk))
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device) \
            if out is None else out
        return y, torch.empty((b, H, hd, B.shape[-1]), dtype=torch.float32,
                              device=x.device)
    if x.device.type == "cpu":
        y, state = ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
        return (y if out is None else out.copy_(y)), state
    if _build.needs_grad(x, dt, A, B, C):
        if out is not None or work is not None:
            raise ValueError("ssd_scan: no in-place out= or work= under "
                             "autograd")
        from repro_torch.kernels.ssd_scan.ops import SSDScanFn

        return SSDScanFn.apply(x, dt, A, B, C, chunk)
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    b, H, S, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, S)
    _check(x, dt, A, B, C, out, Q)
    state = torch.empty((b, H, hd, ds), dtype=torch.float32, device=x.device)
    nw = work_floats(b, H, S, hd, ds, chunk)
    if work is None:
        work = torch.empty(nw, dtype=torch.float32, device=x.device) if nw \
            else None
    elif not nw or work.dtype != torch.float32 or work.numel() != nw \
            or work.device != x.device or not work.is_contiguous():
        raise ValueError(f"ssd_scan: work must be a contiguous float32 "
                         f"tensor of work_floats = {nw} on the chunked "
                         f"route, got {work.dtype} {tuple(work.shape)}")
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


BWD_MAX_HD, BWD_MAX_DS, BWD_MAX_GROUP = 64, 128, 8  # K6b's limits


def bwd_group(b: int, H: int, S: int, chunk: int, sms: int,
              dtype=torch.bfloat16) -> int:
    """Heads per block of K6b's passes over head groups (every pass but the
    carry and the reduce). float32 (scores, dC, dB): as many as keep two
    blocks per SM, at most 8 (``ssd_scan.cu``'s rule). bf16, whose dx/dB
    and dC passes hold an SM with one block: the group of at most 8 heads
    whose blocks take the least time in whole waves, waves x (heads + 1)
    (a block also stages its chunk's B and C rows, about one head's
    loads), the largest on a tie (the fewest dB and dC partials)."""
    nch = -(-S // min(chunk, S))
    if dtype == torch.float32:
        return max(1, min(BWD_MAX_GROUP, b * nch * H // (2 * sms)))
    cost = {g: -(-b * nch * -(-H // g) // sms) * (g + 1)
            for g in range(1, min(BWD_MAX_GROUP, H) + 1)}
    return min(cost, key=lambda g: (cost[g], -g))


def bwd_work_floats(b: int, H: int, S: int, hd: int, ds: int, chunk: int,
                    group: int, dtype=torch.bfloat16) -> int:
    """Floats of K6b's workspace (mirrors ``ssd_scan_bwd_work_floats``):
    per (batch, chunk, head) a state gradient and a total; per (batch, head)
    row cum, U, G's row and column sums and dt's direct part (those three
    float64); per head group dB and dC partials; per (batch, chunk, head) a
    dA partial. The float32 route also keeps the decayed scores P and R (Q
    x Q per head and chunk); the bf16 route keeps them in registers."""
    Q = min(chunk, S)
    nch = -(-S // Q)
    bh = b * H
    ngroups = -(-H // group)
    scores = 2 * bh * nch * Q * Q if dtype == torch.float32 else 0
    return (6 * bh * S + bh * nch * hd * ds + 2 * bh * nch + 2 * bh * S
            + scores + 2 * ngroups * b * S * ds)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ssd_scan_bwd_bhsd(x, dt, A, B, C, dy, dstate=None, *, chunk: int = 128,
                      work=None, dx=None, tally=None):
    """K6b: (dx, ddt, dA, dB, dC) of ``ssd_scan_bhsd(x, dt, A, B, C)`` for
    the cotangents ``dy`` (b, H, S, hd) of y and ``dstate`` (b, H, hd, ds)
    of the final state (None: zero); see the module docstring. ``work`` is
    the workspace the forward filled (``ssd_scan_bhsd(..., work=)``),
    required on CUDA tensors when S spans more than one chunk. dx is the
    given ``dx`` (a strided view is fine) or a new tensor; ddt (b, H, S)
    and dA (H,) are float32, dB and dC (b, S, ds) in B's dtype, contiguous.

    CPU tensors take the plain version (``work`` unused there); CUDA
    tensors launch ``ssd_scan_bwd_{f32,bf16}`` (five tensor-core passes in
    bf16, seven CUDA-core passes in float32: one call, one count) or
    raise. The launch is counted in ``tally`` when given
    (``SSDScanFn`` passes the ``recording`` tally open where its forward
    ran), else in the calling thread's. In a ``kernels.counting`` block,
    fake or meta tensors run nothing: the call is counted and empty
    outputs returned."""
    if _build.abstract(x, dt, A, B, C, dy):
        b, H, S, hd = x.shape
        _build.count("ssd_scan_bwd", *flops.ssd_bwd(b, H, S, hd, B.shape[-1],
                                                    chunk))
        f32 = torch.float32
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                if dx is None else dx,
                torch.empty((b, H, S), dtype=f32, device=x.device),
                torch.empty(A.shape, dtype=f32, device=x.device),
                torch.empty(B.shape, dtype=B.dtype, device=x.device),
                torch.empty(C.shape, dtype=C.dtype, device=x.device))
    if x.device.type == "cpu":
        res = ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate, chunk=chunk)
        return (res[0] if dx is None else dx.copy_(res[0]),) + res[1:]
    _build.refuse_grad("ssd_scan_bwd", x, dt, A, B, C, dy, dstate)
    b, H, S, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, S)
    if dx is None:
        dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _check(x, dt, A, B, C, dx, Q)
    for name, t in (("dy", dy),):
        if t.dtype != x.dtype or t.shape != x.shape or t.device != x.device \
                or t.stride(-1) != 1:
            raise ValueError(f"ssd_scan_bwd: {name} must match x in dtype, "
                             f"shape and device with a contiguous last "
                             f"dimension, got {t.dtype} {tuple(t.shape)} "
                             f"strides {t.stride()}")
    if dstate is not None and (dstate.dtype != torch.float32
                               or dstate.shape != (b, H, hd, ds)
                               or dstate.device != x.device
                               or not dstate.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd: dstate must be a contiguous float32 "
                         f"({b}, {H}, {hd}, {ds}) tensor, got {dstate.dtype} "
                         f"{tuple(dstate.shape)}")
    if hd > BWD_MAX_HD or ds > BWD_MAX_DS:
        raise ValueError(f"ssd_scan_bwd: the kernel takes head_dim <= "
                         f"{BWD_MAX_HD} and state <= {BWD_MAX_DS}, got "
                         f"{hd} and {ds}")
    nch = -(-S // Q)
    if nch > 1:
        nw = work_floats(b, H, S, hd, ds, chunk)
        if work is None or work.dtype != torch.float32 \
                or work.numel() != nw or work.device != x.device:
            raise ValueError("ssd_scan_bwd: CUDA tensors over more than one "
                             "chunk need the forward's workspace "
                             "(ssd_scan_bhsd(..., work=))")
    group = bwd_group(b, H, S, chunk, _sm_count(x.device), x.dtype)
    bwork = torch.empty(bwd_work_floats(b, H, S, hd, ds, chunk, group,
                                        x.dtype),
                        dtype=torch.float32, device=x.device)
    ddt = torch.empty((b, H, S), dtype=torch.float32, device=x.device)
    dA = torch.empty(H, dtype=torch.float32, device=x.device)
    dB = torch.empty((b, S, ds), dtype=B.dtype, device=x.device)
    dC = torch.empty((b, S, ds), dtype=C.dtype, device=x.device)
    vals = [*x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
            *dy.stride()[:3], *dx.stride()[:3]]
    P, I32 = _build.P, _build.I32
    fn = _build.function("ssd_scan_bwd", f"ssd_scan_bwd_{_SUFFIX[x.dtype]}",
                         [P] * 14 + [I32] * 7 + [P, P])
    rc = fn(_build.ptr(x), _build.ptr(dt), _build.ptr(A), _build.ptr(B),
            _build.ptr(C), _build.ptr(dy), _build.ptr(dstate),
            _build.ptr(work if nch > 1 else None), _build.ptr(dx),
            _build.ptr(ddt), _build.ptr(dA), _build.ptr(dB), _build.ptr(dC),
            _build.ptr(bwork), b, H, S, hd, ds, Q, group,
            (ctypes.c_longlong * len(vals))(*vals), _build.stream_of(x))
    _build.check(rc, "ssd_scan_bwd")
    _build.counted(ssd_scan_bwd_bhsd, tally)
    return dx, ddt, dA, dB, dC


ssd_scan_bwd_bhsd.launches = 0


def ssd_chunk_grads(xc, dtc, A, bc, cc, dyc, h_prev, dh_next):
    """One chunk's gradients by the module docstring's formulas, in float32
    on any device, per (batch, head): xc, dyc (b, H, Q, hd); dtc (b, H, Q);
    A (H,); bc, cc (b, Q, ds); h_prev, dh_next (b, H, hd, ds). Returns a
    dict: ``dx`` (b, H, Q, hd); ``ddt`` (b, H, Q), dt's direct part;
    ``dB``, ``dC`` (b, H, Q, ds) per head, not yet summed over heads;
    ``dcum`` (b, H, Q), the gradient of the chunk's cum (before the reverse
    sum); ``dh_prev`` (b, H, hd, ds), the state gradient into the earlier
    chunk. ``ddt`` and ``dcum`` are float64: their sums over the scores
    are taken in float64 (the terms that the reverse sum of ``dcum``
    cancels then cancel exactly), the rest in float32."""
    Q = xc.shape[2]
    cum = torch.cumsum((dtc * A.float()[None, :, None]).double(),
                       dim=-1).float()
    total = cum[..., -1:]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    L = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                              NEG_INF))                    # (b, H, Q, Q)
    W = L * dtc[..., None, :]
    CB = (cc @ bc.transpose(1, 2))[:, None]                # C_q . B_s
    DX = dyc @ xc.transpose(2, 3)                          # dy_q . x_s
    P, R = CB * W, DX * W
    G = P * DX
    e_cum = torch.exp(cum)
    e_s = torch.exp(total - cum)
    ew = e_s * dtc
    V = bc[:, None] @ dh_next.transpose(2, 3)              # dh_next B_s
    HC = dyc @ h_prev                                      # h_prev^T dy_q
    U = e_s * (xc * V).sum(-1)
    T = dtc * U
    Gd = G.double()
    dcum = Gd.sum(-1) - Gd.sum(-2) \
        + (e_cum * (cc[:, None] * HC).sum(-1)).double() - T.double()
    dcum[..., -1] += (torch.exp(total[..., 0])
                      * (dh_next * h_prev).sum((-2, -1))).double() \
        + T.double().sum(-1)
    return {
        "dx": P.transpose(2, 3) @ dyc + ew[..., None] * V,
        "ddt": (CB * DX * L).double().sum(-2) + U.double(),
        "dB": R.transpose(2, 3) @ cc[:, None] + ew[..., None]
        * (xc @ dh_next),
        "dC": R @ bc[:, None] + e_cum[..., None] * HC,
        "dcum": dcum,
        "dh_prev": torch.exp(total)[..., None] * dh_next
        + (e_cum[..., None] * dyc).transpose(2, 3) @ cc[:, None],
    }


def chunk_states(x, dt, A, B, *, chunk: int = 128):
    """The state entering each chunk of the SSD scan, float32 (b, nch, H,
    hd, ds), by the plain version's state update (chunk 0's is zero): what
    the kernel leaves in its workspace (``ssd_scan_bhsd(..., work=)``)."""
    Q = min(chunk, x.shape[2])
    states, _ = _states(_padded_chunks(x, Q, 2), _padded_chunks(dt, Q, 2), A,
                        _padded_chunks(B, Q, 1), Q)
    return torch.stack(states, dim=1)


def reverse_cumsum(dcum):
    """``da_r = sum_{k >= r} dcum_k`` along the last axis, in float64."""
    return torch.cumsum(dcum.double().flip(-1), dim=-1).flip(-1)


def ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate=None, *,
                       chunk: int = 128):
    """The gradient of ``ssd_scan_plain`` by explicit formulas
    (``ssd_chunk_grads``), one chunk at a time from the last, in float32
    from widened inputs on any device. ``dy`` (b, H, S, hd) is y's
    cotangent, ``dstate`` (b, H, hd, ds) the final state's (zero when None).
    Returns (dx in x's dtype, ddt (b, H, S) float32, dA (H,) float32, dB and
    dC (b, S, ds) in B's and C's dtypes)."""
    b, H, S, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, S)
    xf, dyf = _padded_chunks(x, Q, 2), _padded_chunks(dy, Q, 2)
    dtf = _padded_chunks(dt, Q, 2)
    Bf, Cf = _padded_chunks(B, Q, 1), _padded_chunks(C, Q, 1)
    states = chunk_states(x, dt, A, B, chunk=chunk)
    dh = torch.zeros((b, H, hd, ds), dtype=torch.float32, device=x.device) \
        if dstate is None else dstate.float()
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (xf, dtf, Bf, Cf))
    dA = torch.zeros(H, dtype=torch.float64, device=x.device)
    for c in range(states.shape[1] - 1, -1, -1):
        sl = slice(c * Q, (c + 1) * Q)
        g = ssd_chunk_grads(xf[:, :, sl], dtf[:, :, sl], A, Bf[:, sl],
                            Cf[:, sl], dyf[:, :, sl], states[:, c], dh)
        da = reverse_cumsum(g["dcum"])
        dx[:, :, sl] = g["dx"]
        ddt[:, :, sl] = g["ddt"] + A.double()[None, :, None] * da
        dA += (dtf[:, :, sl].double() * da).sum((0, 2))
        dB[:, sl] = g["dB"].sum(1)
        dC[:, sl] = g["dC"].sum(1)
        dh = g["dh_prev"]
    return (dx[:, :, :S].to(x.dtype), ddt[:, :, :S], dA.float(),
            dB[:, :S].to(B.dtype), dC[:, :S].to(C.dtype))
