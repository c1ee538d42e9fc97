"""Attention: GQA/MQA/MHA prefill and single-token decode.

The port of ``repro.modeling.attention``. The reference selects between a
chunked XLA path and its Pallas kernels by ``cfg.attn_impl``; in the port the
device decides, as everywhere in ``repro_torch``: ``attention`` goes through
the flash-attention kernel (K4) and ``decode_attention`` through the
flash-decode kernel (K5), which launch their CUDA kernels for CUDA tensors
and run their plain versions for CPU tensors. ``impl`` is accepted for the
reference's signature and not routed on. Both compute in float32 and round
only the output, as the TPU kernels do (the reference's XLA path rounds the
probabilities to the value dtype before the P·V product, so in bf16 its two
paths differ slightly; the port follows the kernels). Where a training step
needs a gradient through ``attention``, K4's autograd Function runs it, its
backward the hand-written flash-attention backward (K4b); the reference
differentiates its XLA path instead.

The windowed ring-buffer decode (a local-window cache with slot positions)
has no kernel in the reference either and stays plain torch here, computed
as the reference's XLA path computes it.

Context parallelism (``cp_chunked_attention``, taken when ``attention`` is
given ``cp_ways`` > 1: the model passes what the "seq" axis resolves to
under a sharding context with ``cfg.cp_attn``) is plain torch as in the
reference, which has no kernel for it either: the query sequence folded
into (outer, ways, q_chunk) blocks, ``ways`` a tensor dim the sharding
annotates with "seq". On one card "seq" resolves to at most 1 way, so the
card never takes it.
"""

from __future__ import annotations

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -2.0e38


def cp_chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                         q_chunk: int = 512, ways: int = 16, shard_fn=None):
    """Context-parallel flash-style attention, the reference's: the query
    sequence folded into (outer, ways, qc) with ``ways`` a tensor dim that
    ``shard_fn`` annotates with "seq"; a loop over ``outer`` only, each
    block's body checkpointed (its scores are recomputed in the backward
    pass). q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, H, D) in
    v's dtype; scores and softmax in float32, the probabilities rounded to
    v's dtype before the P.V product, as the reference does."""
    shard_fn = shard_fn or (lambda a, axes: a)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    qc = min(q_chunk, max(Sq // ways, 1))
    span = ways * qc
    pad = (-Sq) % span
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    outer = (Sq + pad) // span
    qg = q.reshape(B, outer, ways, qc, Hkv, G, D)
    k_pos = torch.arange(Skv, device=q.device)
    blk_axes = ("batch", "seq", None, None, None, None)

    def body(q_blk, o_idx: int):  # q_blk: (B, ways, qc, Hkv, G, D)
        q_blk = shard_fn(q_blk, blk_axes)
        q_pos = (o_idx * span
                 + torch.arange(ways, device=q.device)[:, None] * qc
                 + torch.arange(qc, device=q.device)[None, :])  # (ways, qc)
        s = torch.einsum("bwqkgd,bskd->bwkgqs", q_blk.float(),
                         k.float()) * scale
        s = shard_fn(s, blk_axes)
        mask = torch.ones((ways, qc, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, None, :] <= q_pos[:, :, None]
        if window and window > 0:
            mask &= k_pos[None, None, :] > (q_pos[:, :, None] - window)
        s = torch.where(mask[None, :, None, None, :, :], s, NEG_INF)
        s = s - s.amax(-1, keepdim=True).detach()
        p = torch.exp(s)
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        out = torch.einsum("bwkgqs,bskd->bwqkgd", p.to(v.dtype), v)
        return shard_fn(out, blk_axes)

    outs = []
    for o in range(outer):
        if torch.is_grad_enabled():
            outs.append(checkpoint(body, qg[:, o], o, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(body(qg[:, o], o))
    out = torch.stack(outs, dim=1).reshape(B, Sq + pad, H, D)
    return out[:, :Sq]


def attention(q, k, v, *, causal=True, window=0, impl="xla", q_chunk=512,
              cp_ways=0, shard_fn=None):
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, H, D): with
    ``cp_ways`` > 1 the context-parallel ``cp_chunked_attention`` (over
    ``q_chunk`` blocks, annotated by ``shard_fn``), else the flash-attention
    kernel; ``impl`` is not routed on. (The reference's ``banded`` shapes
    its chunked XLA path, which the port does not have; the kernel skips
    the key tiles a window leaves out on its own.)"""
    if cp_ways and cp_ways > 1:
        return cp_chunked_attention(q, k, v, causal=causal, window=window,
                                    q_chunk=q_chunk, ways=cp_ways,
                                    shard_fn=shard_fn)
    return fa_ops.flash_attention(q, k, v, causal=causal, window=window)


def _windowed_decode(q, k_cache, v_cache, length, window, positions):
    """The reference's XLA decode with a slot-position window filter."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k_cache.float()) * scale  # (B, Hkv, G, S)
    slot = torch.arange(S, device=q.device)
    valid = slot[None, :] < length[:, None].long()  # (B, S)
    if positions is not None:
        positions = positions.to(q.device)
        pos_b = positions.expand(B, S) if positions.dim() == 1 else positions
        cur = torch.where(valid, pos_b, -1).amax(dim=1, keepdim=True)
        valid &= pos_b > (cur - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    scores = scores - scores.amax(-1, keepdim=True)
    probs = torch.exp(scores)
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, D)


def decode_attention(q, k_cache, v_cache, length, *, window: int = 0,
                     positions=None, impl: str = "xla"):
    """Single-token attention against a KV cache.

    q: (B, 1, H, D); caches: (B, S, Hkv, D); length: (B,) int32 valid cache
    lengths (slots at index >= length are masked; a length above S leaves
    every slot valid). ``positions`` optionally gives each slot's absolute
    position (ring-buffer local-window caches). Without a window this is the
    flash-decode kernel; ``impl`` is not routed on."""
    if window and window > 0:
        return _windowed_decode(q, k_cache, v_cache, length, window, positions)
    return da_ops.decode_attention(q, k_cache, v_cache,
                                   length.to(torch.int32).contiguous())
