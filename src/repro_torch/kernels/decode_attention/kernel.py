"""Flash-decode kernel: CUDA launch wrapper and its plain version.

``decode_attention_bhd`` attends one query token per (batch, head) over a
length-masked KV cache: q (B, H, 1, D), k/v (B, Hkv, S, D), ``lengths`` (B,)
int32; slot ``s`` of row ``b`` is valid when ``s < lengths[b]``, so a length
above S makes every slot valid (the serving executor decodes past its cache,
see ``modeling/lm.py``). It replaces the Pallas kernel of the same name in
the JAX package; the CUDA source is ``repro_torch/csrc/decode_attention.cu``:
split-K over the slot axis, the bf16 path on the tensor cores (the G query
heads of a KV group packed as the rows of one mma tile, each warp streaming
its K/V tiles through a cp.async ring), then a combine of the partial
softmax states when the cache spans more than one split. ``decode_splits``
picks the splits from the shapes and the card's SM count, never from
``lengths``, so a decode step captured in a CUDA graph stays valid as the
lengths change on the device.
Both versions compute in float32 with the TPU kernel's ``NEG_INF = -2e38``
and ``max(l, 1e-30)`` and return the input dtype; a length of 0 gives 0, as
the kernel does (the reference's ``ref.py`` would give the mean of V).

The kernel reads strided views with a contiguous last dimension: the model
passes its (B, S, Hkv, D) cache slices transposed, without a copy.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, flops

NEG_INF = -2.0e38
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEADS_PER_BLOCK = 16  # query heads of a KV group one block serves
SPLIT_ALIGN = 64      # a split's slots are a multiple of this
MIN_SPLIT = 256       # slots of the shortest split the rule makes
BLOCKS_PER_SM = 4     # blocks the split rule aims for per SM
_SM_COUNT: dict[int, int] = {}


def decode_splits(B: int, Hkv: int, G: int, S: int, n_sm: int) \
        -> tuple[int, int]:
    """``(nsplit, chunk)``: the slot axis cut into ``nsplit`` splits of
    ``chunk`` slots (a multiple of ``SPLIT_ALIGN``, or S itself for one
    split) that tile [0, S): enough for ``BLOCKS_PER_SM`` blocks per SM
    over the ``B * Hkv * ceil(G / 16)`` (batch, KV head, head group)
    blocks of one split, and no more splits than ``MIN_SPLIT``-slot pieces
    of S (shorter splits cost more in their combine than they gain: 16
    splits of 256 slots beat 8 and 32 at k/v (4, 8, 4096, 64) in bf16 on an
    H100). A cache of at most ``MIN_SPLIT`` slots (the serving shape,
    S = 32) is one split: one launch, no workspace. Reads no lengths."""
    if S <= MIN_SPLIT:
        return 1, S
    blocks = B * Hkv * -(-G // HEADS_PER_BLOCK)
    want = -(-BLOCKS_PER_SM * n_sm // blocks)
    n = max(1, min(want, -(-S // MIN_SPLIT)))
    if n == 1:
        return 1, S
    chunk = -(-(-(-S // n)) // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-S // chunk), chunk


def workspace_floats(B: int, H: int, D: int, nsplit: int) -> int:
    """float32 workspace of the partial softmax states: ``(m, l, acc[D])``
    per (batch, head, split), none for one split."""
    return B * H * nsplit * (D + 2) if nsplit > 1 else 0


def sm_count(device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _SM_COUNT.get(idx)
    if n is None:
        n = _SM_COUNT[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def decode_attention_plain(q, k, v, lengths):
    """q: (B, H, 1, D); k/v: (B, Hkv, S, D); lengths: (B,) -> (B, H, 1, D)
    in q's dtype, on any device."""
    B, H, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,bksd->bkgs", qf, k.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float()) / l.clamp_min(1e-30)
    return out.reshape(B, H, 1, D).to(q.dtype)


def _check(q, k, v, lengths, out):
    if q.dtype not in _SUFFIX:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be a 4-d tensor with a contiguous "
                             f"last dimension, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    B, H, one, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if one != 1 or k.shape != (B, Hkv, S, D) or v.shape != k.shape \
            or out.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} out {tuple(out.shape)}")
    if Hkv < 1 or H % Hkv or not 1 <= D <= 256 or S < 1:
        raise ValueError(f"need H % Hkv == 0, 1 <= D <= 256 and S >= 1, got "
                         f"H={H} Hkv={Hkv} D={D} S={S}")
    if lengths.dtype != torch.int32 or lengths.device != q.device \
            or lengths.shape != (B,) or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor on "
                         "q's device")


def decode_attention_bhd(q, k, v, lengths, *, out=None):
    """Decode attention of ``q`` (B, H, 1, D) over the cache ``k``/``v``
    (B, Hkv, S, D) masked by ``lengths`` (B,); see the module docstring.
    Returns ``out`` (allocated when not given).

    CPU tensors take the plain version; CUDA tensors launch
    ``decode_attention_{f32,bf16}`` (the split kernel, and the combine
    kernel when ``decode_splits`` gives more than one split) or raise. The
    float32 workspace of the partial softmax states is allocated here. In a
    ``kernels.counting`` block, fake or meta tensors run nothing: the call
    is counted (over every slot) and ``out`` returned."""
    if _build.abstract(q, k, v):
        B, H, _, D = q.shape
        _build.count("decode_attention", *flops.decode(B, H, k.shape[2], D))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device) \
            if out is None else out
    if q.device.type == "cpu":
        res = decode_attention_plain(q, k, v, lengths)
        return res if out is None else out.copy_(res)
    _build.refuse_grad("decode_attention", q, k, v)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check(q, k, v, lengths, out)
    B, H, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    nsplit, chunk = decode_splits(B, Hkv, H // Hkv, S, sm_count(q.device))
    n_ws = workspace_floats(B, H, D, nsplit)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) \
        if n_ws else None
    P, I32 = _build.P, _build.I32
    fn = _build.function("decode_attention",
                         f"decode_attention_{_SUFFIX[q.dtype]}",
                         [P] * 6 + [I32] * 5 + [P, _build.F32, I32, I32, P])
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(lengths),
            _build.ptr(out), _build.ptr(ws), B, H, Hkv, S, D,
            _build.strides(q[:, :, 0], k, v, out[:, :, 0]), 1.0 / (D ** 0.5),
            nsplit, chunk, _build.stream_of(q))
    _build.check(rc, "decode_attention")
    _build.counted(decode_attention_bhd)
    return out


decode_attention_bhd.launches = 0
