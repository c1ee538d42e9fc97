"""Mixture-of-Experts layer (Gshard-style capacity-based dispatch/combine):
the port of ``repro.modeling.moe``, operation for operation.

Tokens are grouped into ``cfg.moe_group``-token groups; each group gives
every expert C slots (``moe_capacity``). A one-hot dispatch tensor
(B, nG, g, E, C) gathers each expert's tokens, the experts run as one
batched product over (E, C) rows, and a combine tensor carrying the gate
weights scatters their outputs back. Assignments past an expert's C slots
are dropped. The dispatch and combine are plain products here as in the
reference, where they are einsums outside any Pallas kernel.

Where the reference's primitives and PyTorch's differ, the port computes
the reference's numbers:

- the router is a float32 product with the float32 router weights (the
  reference never casts ``router/w``, so a bf16 ``x`` is promoted);
- ``jax.lax.top_k`` takes the lower expert index first among equal
  probabilities: the port takes the top K of a stable descending sort;
- ``jax.nn.one_hot`` gives an all-zero row for an index past its classes,
  which is how a dropped assignment vanishes: the port builds both one-hots
  by comparison with ``arange``;
- ``dispatch`` and ``combine`` are rounded to the activation dtype before
  their products (in a bf16 executor the gate weights are bf16 there).

No step reads a device value on the host, and every shape is static: a
prefill and a decode step with MoE layers capture in CUDA graphs.

The capacity keeps the configured group in decode, as the reference does:
``moe_capacity`` reads ``cfg.moe_group``, not the group a step has, so a
decode step (S = 1) still gives every expert C slots, and the expert
products run over all E x C of them. The ``cfg.moe_batch_groups`` path
pools a decode step's B tokens into one group with its own capacity.

Load-balancing auxiliary loss (Switch/Gshard): E * sum_e f_e * P_e.
"""

from __future__ import annotations

import math

import torch

from repro_torch.modeling.layers import activation, is_gated
from repro_torch.modeling.module import ParamSpec


def moe_capacity(cfg) -> int:
    g, k, e = cfg.moe_group, cfg.top_k, cfg.n_experts
    c = math.ceil(g * k / e * cfg.capacity_factor)
    return max(4, int(math.ceil(c / 4) * 4))


def moe_specs(cfg) -> dict[str, ParamSpec]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    specs = {
        "router/w": ParamSpec((d, e), ("embed", "experts")),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed")),
    }
    if is_gated(cfg.act):
        specs["wi_0"] = ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"))
        specs["wi_1"] = ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"))
    else:
        specs["wi"] = ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"))
    return specs


def moe_apply(cfg, p: dict, x, shard_fn=None):
    """x: (B, S, D) -> (y, aux_loss). ``p`` holds this layer's MoE params;
    ``shard_fn(tensor, logical axes)`` annotates the dispatch and the
    expert inputs and outputs (the model passes ``sharding.shard``; the
    identity when None).

    With ``cfg.moe_batch_groups``, a step shorter than a group (decode)
    with B > 1 pools all B·S tokens into one group (one capacity pool)."""
    shard = shard_fn or (lambda a, axes: a)
    B, S, D = x.shape
    if getattr(cfg, "moe_batch_groups", False) and S < cfg.moe_group and B > 1:
        y, aux = _moe_apply_grouped(cfg, p, x.reshape(1, B * S, D), shard,
                                    batch_in_group=True)
        return y.reshape(B, S, D), aux
    return _moe_apply_grouped(cfg, p, x, shard, batch_in_group=False)


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int):
    """``jax.nn.one_hot(idx, n)`` in float32: all zeros where ``idx`` is
    outside [0, n) (``torch.nn.functional.one_hot`` would raise there)."""
    classes = torch.arange(n, device=idx.device, dtype=idx.dtype)
    return (idx[..., None] == classes).float()


def _route(cfg, p: dict, xg, C: int):
    """The router of (B, nG, g, D) grouped tokens with C slots an expert:
    (probs (B, nG, g, E), gate_vals (B, nG, g, K), expert_idx (B, nG, g, K),
    keep (B, nG, g, K), eoh (B, nG, g, K, E), poh (B, nG, g, K, C)), all
    float32 but the indices and ``keep``."""
    B, nG, g, _ = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = xg.float() @ p["router/w"].float()  # (B, nG, g, E) float32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, K)
    if K > 1:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # position of each (token, k) assignment within its expert's buffer:
    # flatten (g, K) in token-major priority order and cumulative-sum
    eoh = _one_hot(expert_idx, E)  # (B, nG, g, K, E)
    flat = eoh.reshape(B, nG, g * K, E)
    pos = torch.cumsum(flat, dim=2) * flat - 1.0
    pos = pos.reshape(B, nG, g, K, E)
    within = (pos >= 0) & (pos < C)
    pos_idx = (pos * eoh).sum(dim=-1)  # (B, nG, g, K)
    keep = (within & (eoh > 0)).any(dim=-1)
    poh = _one_hot(pos_idx, C) * keep[..., None]
    return probs, gate_vals, expert_idx, keep, eoh, poh


def _moe_apply_grouped(cfg, p: dict, x, shard, batch_in_group: bool):
    B, S, D = x.shape
    g = min(cfg.moe_group, S)
    while S % g:  # largest divisor of S not exceeding the requested group size
        g -= 1
    nG = S // g
    # with batch_in_group, the flattened token dim keeps the batch sharding
    tok_axes = (None, None, "batch") if batch_in_group \
        else ("batch", None, None)
    E, K = cfg.n_experts, cfg.top_k
    if batch_in_group:
        # capacity from the actual pooled-token count (decode: g = B·S)
        c = math.ceil(g * K / E * cfg.capacity_factor)
        C = max(2, int(math.ceil(c / 2) * 2))
    else:
        C = moe_capacity(cfg)

    xg = x.reshape(B, nG, g, D)
    probs, gate_vals, _, _, eoh, poh = _route(cfg, p, xg, C)
    # dispatch: (B, nG, g, E, C); combine adds the gate weight
    dispatch = torch.einsum("bngke,bngkc->bngec", eoh, poh)
    combine = torch.einsum("bngke,bngkc->bngec", eoh * gate_vals[..., None],
                           poh)
    dispatch = shard(dispatch, tok_axes + ("experts", None))

    # ---- expert computation: one batched product over (E, C) rows --------
    dt = x.dtype
    xe = torch.einsum("bngec,bngd->bnecd", dispatch.to(dt), xg)
    xe = shard(xe, (tok_axes[0], None, "experts", None, None))
    if is_gated(cfg.act):
        h = activation(
            cfg.act,
            torch.einsum("bnecd,edf->bnecf", xe, p["wi_0"].to(dt)),
            torch.einsum("bnecd,edf->bnecf", xe, p["wi_1"].to(dt)))
    else:
        h = activation(cfg.act,
                       torch.einsum("bnecd,edf->bnecf", xe, p["wi"].to(dt)))
    ye = torch.einsum("bnecf,efd->bnecd", h.to(dt), p["wo"].to(dt))
    ye = shard(ye, (tok_axes[0], None, "experts", None, None))
    y = torch.einsum("bngec,bnecd->bngd", combine.to(dt), ye)
    y = y.reshape(B, S, D)

    # ---- Switch-style load-balancing aux loss ----------------------------
    frac_tokens = (eoh[..., 0, :] if K == 1 else eoh.amax(dim=3)).mean(
        dim=(0, 1, 2))  # fraction routed per expert
    frac_probs = probs.mean(dim=(0, 1, 2))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux
