"""Flash-attention kernel: CUDA launch wrapper and its plain version.

``flash_attention_bhsd`` computes causal or local-window GQA attention over
(B, H, S, D) operands: query head ``h`` attends with K/V head
``h // (H // Hkv)``, query position ``i`` sees key ``j`` when ``j <= i``
(causal) and ``j > i - window`` (``window > 0``). It replaces the Pallas
kernel of the same name in the JAX package; the CUDA source is
``repro_torch/csrc/flash_attention.cu``. Both versions compute in float32
(scores, online or full softmax, the P·V product) with the TPU kernel's
``NEG_INF = -2e38`` and ``max(l, 1e-30)``, and return the input dtype. A row
with no visible key gives 0, as the kernel does (the reference's ``ref.py``
would give the mean of V there; no causal self-attention row has none).

The kernel reads strided views whose last dimension is contiguous, so the
model's (B, S, H, D) tensors pass in transposed, without a copy, and ``out``
may be such a view too. Given ``lse``, a float32 (B, H, Sq) tensor, it also
writes each row's log-sum-exp: ``log(sum_j exp(scale * q_i . k_j))`` over
the row's visible keys (natural log of the scaled scores, the plain
version's ``return_lse``), ``+inf`` for a row with no visible key, so that
``exp(scale * s - lse)`` is the forward's probability and exactly 0 on such
a row. Without it the kernel writes nothing more (the serving path).

``flash_attention_bwd_bhsd`` (K4b) is its gradient, hand-written for the
card (``repro_torch/csrc/flash_attention_bwd.cu``; the reference has no
Pallas backward and differentiates its XLA chunked attention instead):
given the forward's output, its ``lse`` and the cotangent it returns dq, dk
and dv with the same mask and no atomics (bf16: the products on the tensor
cores, float32 accumulation; float32: CUDA cores).
``flash_attention_bwd_plain`` writes the same gradient out as formulas on
the full score matrix. Where autograd needs a gradient through
``flash_attention_bhsd`` on the card, the call goes through
``ops.FlashAttentionFn``, whose forward saves K4's ``lse`` and whose
backward is K4b.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, flops

NEG_INF = -2.0e38
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _mask(Sq: int, Skv: int, causal: bool, window: int, device):
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Skv, device=device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window and window > 0:
        m &= kj > qi - window
    return m


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """q: (B, H, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, H, Sq, D) in q's dtype,
    on any device: the full (Sq, Skv) score matrix in float32. With
    ``return_lse`` also the float32 (B, H, Sq) log-sum-exp of each row's
    visible scaled scores (``+inf`` where a row sees no key)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * scale
    mask = _mask(Sq, Skv, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float()) / l.clamp_min(1e-30)
    out = out.reshape(B, H, Sq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)
    return out, lse.reshape(B, H, Sq)


def _check_lse(lse, q):
    B, H, Sq, _ = q.shape
    if lse.dtype != torch.float32 or lse.device != q.device \
            or lse.shape != (B, H, Sq) or lse.stride(-1) != 1:
        raise ValueError(f"lse must be float32 {(B, H, Sq)} on {q.device} "
                         f"with a contiguous last dimension, got {lse.dtype} "
                         f"{tuple(lse.shape)} strides {lse.stride()} on "
                         f"{lse.device}")


def _check(q, k, v, out):
    if q.dtype not in _SUFFIX:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be a 4-d tensor with a contiguous "
                             f"last dimension, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Skv, D) or v.shape != k.shape \
            or out.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} out {tuple(out.shape)}")
    if Hkv < 1 or H % Hkv or not 1 <= D <= 256:
        raise ValueError(f"need H % Hkv == 0 and 1 <= D <= 256, got H={H} "
                         f"Hkv={Hkv} D={D}")


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0,
                         out=None, lse=None):
    """Attention of ``q`` (B, H, Sq, D) over ``k``/``v`` (B, Hkv, Skv, D);
    see the module docstring. Returns ``out`` (allocated when not given);
    a given ``lse`` (float32 (B, H, Sq)) is filled with the rows'
    log-sum-exp.

    CPU tensors take the plain version; CUDA tensors launch
    ``flash_attention_{f32,bf16}`` or raise. Where autograd needs a
    gradient through the call on the card it goes through
    ``ops.FlashAttentionFn`` (forward K4, backward K4b), which writes no
    ``out`` or ``lse`` in place. In a ``kernels.counting`` block, fake or
    meta tensors run nothing: the call is counted and ``out`` returned
    (``lse`` is left as given)."""
    if _build.abstract(q, k, v):
        B, H, Sq, D = q.shape
        _build.count("flash_attention", *flops.attention(
            B, H, Sq, k.shape[2], D, causal, window))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device) \
            if out is None else out
    if q.device.type != "cpu" and _build.needs_grad(q, k, v):
        if out is not None or lse is not None:
            raise ValueError("flash_attention: no in-place out= or lse= "
                             "under autograd")
        from repro_torch.kernels.flash_attention.ops import FlashAttentionFn

        return FlashAttentionFn.apply(q, k, v, causal, window)
    if lse is not None:
        _check_lse(lse, q)
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    return_lse=lse is not None)
        if lse is not None:
            res, row_lse = res
            lse.copy_(row_lse)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check(q, k, v, out)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    P, I32 = _build.P, _build.I32
    fn = _build.function("flash_attention", f"flash_attention_{_SUFFIX[q.dtype]}",
                         [P] * 5 + [I32] * 6 + [P, I32, I32, _build.F32, P])
    with_lse = (q, k, v, out) if lse is None else (q, k, v, out, lse)
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _build.ptr(lse), B, H, Hkv, Sq, Skv, D, _build.strides(*with_lse),
            int(bool(causal)), int(window or 0), 1.0 / (D ** 0.5),
            _build.stream_of(q))
    _build.check(rc, "flash_attention")
    _build.counted(flash_attention_bhsd)
    return out


flash_attention_bhsd.launches = 0


def flash_attention_bwd_plain(q, k, v, o, do, *, causal: bool = True,
                              window: int = 0, lse=None):
    """The gradient of ``flash_attention_plain`` as explicit formulas on the
    full (Sq, Skv) score matrix, in float32 on any device: P the normalised
    probabilities (0 where masked; ``exp(s * scale - lse)`` from the
    forward's row log-sum-exp when ``lse`` is given, as K4b forms it),
    ``dv = P^T do``, ``dP = do v^T``, ``delta = rowsum(do * o)`` from the
    given forward output ``o``, ``dS = P (dP - delta)``,
    ``dq = dS k * scale`` and ``dk = dS^T q * scale``, dk and dv summed over
    each K/V head's G query heads. Returns (dq, dk, dv) in the dtypes of q,
    k and v."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, G, Sq, D)
    gf = do.float().reshape(B, Hkv, G, Sq, D)
    of = o.float().reshape(B, Hkv, G, Sq, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    mask = _mask(Sq, Skv, causal, window, q.device)
    if lse is None:
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    else:
        p = torch.where(mask, torch.exp(
            s - lse.float().reshape(B, Hkv, G, Sq, 1)), 0.0)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, gf)
    dp = torch.einsum("bkgqd,bksd->bkgqs", gf, vf)
    delta = (gf * of).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bwd_splits(B: int, Hkv: int, Skv: int, G: int) -> int:
    """How many blocks K4b's bf16 dk/dv pass splits each KV head's G query
    heads over on the current card (``flash_attention_bwd_splits``): 1
    while its B x Hkv x key tiles fill the SMs."""
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd_splits",
                         [_build.I32] * 4)
    n = fn(B, Hkv, Skv, G)
    if n < 1:
        raise _build.KernelLaunchError("flash_attention_bwd_splits: no "
                                       "CUDA device")
    return n


def flash_attention_bwd_bhsd(q, k, v, o, do, *, causal: bool = True,
                             window: int = 0, lse=None, dq=None, dk=None,
                             dv=None, tally=None):
    """dq, dk, dv of ``flash_attention_bhsd(q, k, v)`` for its output ``o``,
    its row log-sum-exp ``lse`` (float32 (B, H, Sq), from
    ``flash_attention_bhsd(..., lse=)``) and the cotangent ``do`` (both
    (B, H, Sq, D)); see the module docstring. Returns (dq, dk, dv), each the
    given output (a strided view is fine) or a new tensor.

    CPU tensors take the plain version (``lse`` optional there); CUDA
    tensors launch ``flash_attention_bwd_{f32,bf16}`` (row deltas, dk/dv, a
    sum of head-split partials where the bf16 pass splits, then dq; one
    call, one count) or raise, also without ``lse``. The launch is counted
    in ``tally`` when given (``FlashAttentionFn`` passes the ``recording``
    tally open where its forward ran), else in the calling thread's. In a
    ``kernels.counting`` block, fake or meta tensors run nothing: the call
    is counted and empty (or the given) gradients returned."""
    if _build.abstract(q, k, v, o, do):
        B, H, Sq, D = q.shape
        _build.count("flash_attention_bwd", *flops.attention_bwd(
            B, H, Sq, k.shape[2], D, causal, window))
        return tuple(torch.empty(like.shape, dtype=like.dtype,
                                 device=like.device) if t is None else t
                     for t, like in ((dq, q), (dk, k), (dv, v)))
    if q.device.type == "cpu":
        res = flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                        window=window, lse=lse)
        return tuple(r if t is None else t.copy_(r)
                     for r, t in zip(res, (dq, dk, dv)))
    _build.refuse_grad("flash_attention_bwd", q, k, v, o, do)
    if lse is None:
        raise ValueError("flash_attention_bwd: CUDA tensors need the "
                         "forward's lse (flash_attention_bhsd(..., lse=))")
    _check_lse(lse, q)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device) \
        if dq is None else dq
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device) \
        if dk is None else dk
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device) \
        if dv is None else dv
    _check(q, k, v, o)
    for name, t, like in (("do", do, q), ("dq", dq, q), ("dk", dk, k),
                          ("dv", dv, k)):
        if t.dtype != q.dtype or t.device != q.device \
                or t.shape != like.shape or t.stride(-1) != 1:
            raise ValueError(f"{name} must match {tuple(like.shape)} in "
                             f"q's dtype and device with a contiguous last "
                             f"dimension, got {t.dtype} {tuple(t.shape)} "
                             f"strides {t.stride()} on {t.device}")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    nsplit = bwd_splits(B, Hkv, Skv, H // Hkv) \
        if q.dtype == torch.bfloat16 else 1
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    work = torch.empty((nsplit, 2, B, Hkv, Skv, D), dtype=torch.float32,
                       device=q.device) if nsplit > 1 else None
    P, I32 = _build.P, _build.I32
    fn = _build.function("flash_attention_bwd",
                         f"flash_attention_bwd_{_SUFFIX[q.dtype]}",
                         [P] * 11 + [I32] * 6 + [P, I32, I32, _build.F32,
                                                 I32, P])
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
            _build.ptr(do), _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
            _build.ptr(lse), _build.ptr(delta), _build.ptr(work), B, H, Hkv,
            Sq, Skv, D, _build.strides(q, k, v, o, do, dq, dk, dv, lse),
            int(bool(causal)), int(window or 0), 1.0 / (D ** 0.5), nsplit,
            _build.stream_of(q))
    _build.check(rc, "flash_attention_bwd")
    _build.counted(flash_attention_bwd_bhsd, tally)
    return dq, dk, dv


flash_attention_bwd_bhsd.launches = 0
