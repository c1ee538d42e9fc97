"""Loss functions, the port of ``repro.modeling.losses``.

``chunked_softmax_xent`` never holds the full (B, S, V) logits: it walks the
sequence in chunks, each chunk's body under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``), so at most one (B, chunk, V) float32 logits
block is alive, in the forward and again when the backward recomputes it.
The logits are float32 products of ``cfg.dtype`` operands
(``lm.logits_f32``); the target logit is taken with a one-hot sum
(``impl="onehot"``, the reference's default) or a gather (``"gather"``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import shard
from repro_torch.modeling.layers import softcap
from repro_torch.modeling.lm import logits_f32


def _xent_sum(h_c, w_unembed, t_c, m_c, cap: float, impl: str):
    """(masked loss sum, mask sum) of one (B, c) chunk."""
    B, c, D = h_c.shape
    logits = logits_f32(h_c.reshape(B * c, D), w_unembed).reshape(B, c, -1)
    logits = shard(softcap(logits, cap), ("batch", None, "vocab"))
    lse = torch.logsumexp(logits, dim=-1)
    t = t_c.long()[..., None]
    if impl == "gather":
        lt = torch.gather(logits, -1, t)[..., 0]
    else:
        # the float32 one-hot, made without an int64 (B, c, V) one-hot
        onehot = torch.zeros_like(logits).scatter_(-1, t, 1.0)
        lt = torch.sum(logits * onehot, dim=-1)
    return torch.sum((lse - lt) * m_c), torch.sum(m_c)


def chunked_softmax_xent(h, w_unembed, targets, mask, *, chunk: int = 1024,
                         cap: float = 0.0, impl: str = "onehot"):
    """h: (B, S, D); w_unembed: (D, V); targets/mask: (B, S). Returns
    (loss sum, mask sum), float32 scalars. The chunk is the largest divisor
    of S not above ``chunk``; the chunks' sums are added in order, from 0."""
    B, S, D = h.shape
    c = min(chunk, S)
    while S % c:  # largest divisor of S not exceeding the requested chunk
        c -= 1
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, c):
        args = (h[:, i:i + c], w_unembed, targets[:, i:i + c],
                mask[:, i:i + c], cap, impl)
        if torch.is_grad_enabled():
            ls, dn = checkpoint(_xent_sum, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            ls, dn = _xent_sum(*args)
        loss_sum = loss_sum + ls
        denom = denom + dn
    return loss_sum, denom


def full_softmax_xent(h, w_unembed, targets, mask, cap: float = 0.0):
    """The unchunked path (tests and the baseline): (loss sum, mask sum)."""
    B, S, D = h.shape
    logits = logits_f32(h.reshape(B * S, D), w_unembed).reshape(B, S, -1)
    logits = shard(softcap(logits, cap), ("batch", None, "vocab"))
    lse = torch.logsumexp(logits, dim=-1)
    onehot = torch.zeros_like(logits).scatter_(-1, targets.long()[..., None],
                                               1.0)
    lt = torch.sum(logits * onehot, dim=-1)
    return torch.sum((lse - lt) * mask), torch.sum(mask)
