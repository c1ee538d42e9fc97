"""Decoder-only LM covering the dense / MoE / VLM families: the port of
``repro.modeling.lm``.

One implementation parameterized by ``ArchConfig``, operation for operation
as the reference computes it: GQA/MQA/MHA attention with RoPE (optionally
local-windowed), gated (SwiGLU/GeGLU) or plain (squared-ReLU/GeLU) MLPs or
Gshard MoE layers (``modeling/moe.py``, with an optional shared expert,
llama4-style), stacked per-layer parameters walked by a Python loop (the
reference's ``lax.scan``), an optional vision prefix (projected
``vision_embeds`` prepended to the tokens, InternVL-style), prefill (cache
build) and single-token decode, with an optional int8 KV cache
(``cfg.kv_quant``).

``moe_every = k`` (read with ``getattr``, as the reference reads it: the
config has no such field) puts an MoE layer on every k-th layer: the
parameters are a stack of the G·(k-1) dense layers and one of the G MoE
layers, walked group by group (k-1 dense, then the MoE layer), and the
cache holds the layers in that order. Like the reference, the grouped
layout refuses ``kv_quant``.

The model is stateless: like the reference it takes its flat parameter dict
``{path: tensor}`` on every call, so the same object serves float32 masters,
an executor's bf16 casts and parameters carried over from the JAX package
(``modeling/convert.py``). Parameters are float32 (``cfg.param_dtype``) and
are cast to ``cfg.dtype`` where they are used (a no-op for a parameter that
is already in that dtype); norm scales and the MoE router are used in
float32; the logits are float32 with float32 accumulation from
``cfg.dtype`` operands.

Sharding: the model annotates its activations with ``shard(x, logical
axes)`` (``distributed/sharding.py``) where the reference does; outside a
``sharding_ctx`` each call returns its input, so a single-card run
computes as it did before. With ``cfg.cp_attn`` a training or prefill
layer's attention is ``cp_chunked_attention`` when the context's "seq"
axis resolves to more than one way (never on one card); ``cfg.sp_acts``
annotates a training layer's residuals as sequence-sharded.

Serving trap kept on purpose: the reference writes a decode step's K/V with
``lax.dynamic_update_slice``, which clamps the start so the update fits. An
executor that decodes past its cache therefore overwrites the last slot at
every step, and the step's valid length ``pos + 1`` runs past the cache, so
every slot stays valid. The port writes at ``min(pos, kv_len - 1)`` and
hands the flash-decode kernel the same length. With ``kv_quant`` the cache
holds int8 K/V with a float32 scale per (slot, head); a decode step writes
the quantized token there and dequantizes the whole cache before the
flash-decode kernel, as the reference does.

``loss`` is the chunked cross-entropy (``modeling/losses.py``) plus, with
MoE layers, 0.01 times the layers' mean load-balancing loss; ``cfg.remat``
checkpoints each training layer (each group in the grouped layout,
``_maybe_remat``): under ``"full"`` a layer's forward runs again in the
backward pass, so its attention launches K4 twice per step and its backward
K4b once.

``decode_step`` writes the new K/V into ``cache`` and advances
``cache["pos"]`` in place (the JAX step returns a new cache): on the card a
serving executor replays the step from a CUDA graph over static buffers,
and the clamp, the write and the lengths are computed on the device.
"""


from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import kernels
from repro_torch.distributed.sharding import axis_ways, shard
from repro_torch.modeling.attention import attention, decode_attention
from repro_torch.modeling.layers import (
    activation,
    apply_norm,
    apply_rope,
    is_gated,
    norm_specs,
)
from repro_torch.modeling.moe import moe_apply, moe_specs
from repro_torch.modeling.module import (
    ParamSpec,
    abstract_params,
    init_params,
    layer_slices,
    param_count,
    prefix_specs,
    stacked,
    subtree,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def mlp_specs(cfg, d_ff: int) -> dict[str, ParamSpec]:
    d = cfg.d_model
    s = {"wo": ParamSpec((d_ff, d), ("mlp", "embed"))}
    if is_gated(cfg.act):
        s["wi_0"] = ParamSpec((d, d_ff), ("embed", "mlp"))
        s["wi_1"] = ParamSpec((d, d_ff), ("embed", "mlp"))
    else:
        s["wi"] = ParamSpec((d, d_ff), ("embed", "mlp"))
    return s


def mlp_apply(cfg, p: dict, x):
    dt = x.dtype
    if is_gated(cfg.act):
        h = activation(cfg.act, x @ p["wi_0"].to(dt), x @ p["wi_1"].to(dt))
    else:
        h = activation(cfg.act, x @ p["wi"].to(dt))
    h = shard(h, ("batch", None, "mlp_act"))
    return h @ p["wo"].to(dt)


def attn_specs(cfg) -> dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "q": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "k": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "v": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "o": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }


def _project(h, w):
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, nh, hd = w.shape
    return (h @ w.reshape(d, nh * hd)).unflatten(-1, (nh, hd))


def attn_qkv(cfg, p: dict, h, positions):
    dt = h.dtype
    q = _project(h, p["q"].to(dt))
    k = _project(h, p["k"].to(dt))
    v = _project(h, p["v"].to(dt))
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, ("batch", None, "heads", None))
    k = shard(k, ("batch", None, "kv_heads", None))
    v = shard(v, ("batch", None, "kv_heads", None))
    return q, k, v


class _MixedLogits(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=float32)`` with a backward: PyTorch has no
    derivative for ``aten::mm.dtype``. The backward takes the float32
    cotangent as it is, as the reference's transpose of its
    ``preferred_element_type=float32`` product does: ``dx = g w^T`` and
    ``dw = x^T g`` in float32, each rounded once to its operand's dtype
    (nothing rounds the logits or their cotangent to bf16)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g @ w.float().T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x.float().T @ g).to(w.dtype)
        return dx, dw


def logits_f32(x, w):
    """(B, d) @ (d, V) with float32 accumulation and a float32 result from
    operands in ``x``'s dtype (the reference's
    ``preferred_element_type=float32``). On the card a bf16 product goes to
    one matmul with a float32 output; nothing makes a float32 copy of the
    (d, V) unembedding there (its backward, ``_MixedLogits``, does)."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _MixedLogits.apply(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def kv_quantize(x):
    """(..., hd) -> (int8 values, float32 scales with a trailing 1-dim): the
    largest |x| of each row maps to 127, rounding half to even as
    ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the matmuls' outputs, recompute the rest (the
    reference's ``dots_with_no_batch_dims_saveable``)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.mm.dtype)


def _maybe_remat(fn, remat: str):
    """``fn`` under activation checkpointing: ``"full"`` recomputes all of
    its forward in the backward pass (``torch.utils.checkpoint``),
    ``"dots"`` keeps the matmuls' outputs and recomputes the rest
    (``create_selective_checkpoint_contexts``), ``"none"`` keeps
    everything. Applied to a training layer only when grad mode is on."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _save_dots)
    elif remat != "full":
        raise ValueError(f"unknown remat {remat!r}")
    # the recompute runs on autograd's device thread: carry the caller's
    # recording block there, so its K4 relaunches are tallied with the step
    return partial(checkpoint, kernels.carry_recording(fn),
                   use_reentrant=False, preserve_rng_state=False, **kw)


class LM(nn.Module):
    """The decoder. An ``nn.Module`` without registered parameters: every
    method takes the flat parameter dict, as the reference does."""

    # the batch key of the loss's position mask
    loss_mask_key = "loss_mask"

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        if cfg.kv_quant and self._layout()[1]:
            raise NotImplementedError(
                f"{cfg.name}: kv_quant: grouped (moe_every) layout not "
                "supported")

    # ------------------------------------------------------------- layout
    @property
    def moe_every(self) -> int:
        return getattr(self.cfg, "moe_every", 1) if self.cfg.n_experts else 1

    def _layout(self) -> tuple[int, int]:
        """(n_groups, dense_per_group) of the grouped layout; (n_layers, 0)
        when every layer is of one kind."""
        e = self.moe_every
        if e <= 1:
            return self.cfg.n_layers, 0
        if self.cfg.n_layers % e:
            raise ValueError(f"{self.cfg.name}: n_layers {self.cfg.n_layers} "
                             f"is not a multiple of moe_every {e}")
        return self.cfg.n_layers // e, e - 1

    # ------------------------------------------------------------- params
    def layer_specs(self, moe: bool | None = None) -> dict[str, ParamSpec]:
        cfg = self.cfg
        if moe is None:
            moe = bool(cfg.n_experts)
        s: dict[str, ParamSpec] = {}
        s.update(prefix_specs("ln_attn", norm_specs(cfg.norm, cfg.d_model)))
        s.update(prefix_specs("attn", attn_specs(cfg)))
        s.update(prefix_specs("ln_mlp", norm_specs(cfg.norm, cfg.d_model)))
        if moe:
            s.update(prefix_specs("moe", moe_specs(cfg)))
            if cfg.shared_expert:
                s.update(prefix_specs("shared_mlp", mlp_specs(cfg, cfg.d_ff)))
        else:
            s.update(prefix_specs("mlp", mlp_specs(cfg, cfg.d_ff)))
        return s

    def param_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        specs: dict[str, ParamSpec] = {
            "embed/w": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                                 init="embed"),
        }
        if cfg.vision_feat_dim:
            specs["vision_proj/w"] = ParamSpec(
                (cfg.vision_feat_dim, cfg.d_model), (None, "embed"))
        G, dpg = self._layout()
        if dpg == 0:
            specs.update(prefix_specs(
                "layers", {k: stacked(v, cfg.n_layers)
                           for k, v in self.layer_specs().items()}))
        else:
            specs.update(prefix_specs(
                "layers_dense", {k: stacked(v, G * dpg) for k, v in
                                 self.layer_specs(moe=False).items()}))
            specs.update(prefix_specs(
                "layers_moe", {k: stacked(v, G) for k, v in
                               self.layer_specs(moe=True).items()}))
        specs.update(prefix_specs("ln_f", norm_specs(cfg.norm, cfg.d_model)))
        if not cfg.tie_embeddings:
            specs["unembed/w"] = ParamSpec(
                (cfg.d_model, cfg.vocab), ("embed", "vocab"),
                scale=cfg.d_model ** -0.5)
        return specs

    def init(self, generator: torch.Generator, device=None,
             cast=None) -> dict[str, torch.Tensor]:
        """Fresh parameters in ``cfg.param_dtype`` drawn from ``generator``
        (on ``device``); ``cast`` as in ``module.init_params``."""
        return init_params(generator, self.param_specs(),
                           torch_dtype(self.cfg.param_dtype), device, cast)

    def serving_cast(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """A parameter as a server holds it: every matrix cast to
        ``cfg.dtype`` (as each use would cast it); norm parameters and the
        MoE router's weights kept in float32 (they are used in float32). A
        top-level parameter, whose path has no ``/`` (the encoder's
        ``mask_emb``), belongs to no norm: it is cast to ``cfg.dtype``, as
        its use casts it."""
        parts = path.split("/")
        owner = parts[-2] if len(parts) > 1 else ""
        if owner.startswith("ln_") or parts[-3:-1] == ["moe", "router"]:
            return t
        return t.to(self.dtype)

    def abstract_params(self, dtype=None) -> dict[str, torch.Tensor]:
        """Every parameter as a ``meta`` tensor (default dtype
        ``cfg.param_dtype``): nothing is allocated."""
        return abstract_params(self.param_specs(),
                               dtype or torch_dtype(self.cfg.param_dtype))

    def param_count(self) -> int:
        return param_count(self.param_specs())

    def active_param_count(self) -> int:
        """Active params per token (differs from the total for MoE)."""
        cfg = self.cfg
        total = 0
        for path, s in self.param_specs().items():
            n = int(np.prod(s.shape))
            if "/moe/" in path and "router" not in path:
                n = n * max(cfg.top_k, 1) // max(cfg.n_experts, 1)
            total += n
        return total

    def _unembed(self, params):
        if self.cfg.tie_embeddings:
            return params["embed/w"].T
        return params["unembed/w"]

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    # ------------------------------------------------------------ forward
    def _embed(self, params, tokens):
        # gather, then cast: the same values as the reference's cast-then-
        # gather, without casting the whole (vocab, d) table
        return params["embed/w"][tokens.long()].to(self.dtype)

    def _embed_inputs(self, params, batch):
        """The tokens' embeddings, after the projected ``vision_embeds``
        (B, V, vision_feat_dim) when the config has a vision prefix and the
        batch carries them."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.vision_feat_dim and "vision_embeds" in batch:
            dt = self.dtype
            ve = batch["vision_embeds"].to(dt) @ params["vision_proj/w"].to(dt)
            x = torch.cat([ve, x], dim=1)
        return shard(x, ("batch", None, None))

    def _cache_entries(self, k, v) -> dict:
        """A layer's K/V as its cache holds them: ``{"k", "v"}``, with
        ``kv_quant`` int8 values and their float32 scales ``"k_scale"``,
        ``"v_scale"``."""
        if not self.cfg.kv_quant:
            return {"k": k, "v": v}
        (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}

    def _layer(self, p, x, positions, mode, moe=False, kv=None, slot=None,
               lengths=None):
        """One transformer layer: (x, aux or None, kv). ``p`` holds this
        layer's (unstacked) params. In decode mode ``kv`` holds this
        layer's cache slices by name (``_cache_entries``; (B, kv_len, Hkv,
        D), the scales (B, kv_len, Hkv, 1)), written in place at ``slot``;
        in prefill mode the returned ``kv`` holds the layer's entries for
        the prompt. ``aux`` is an MoE layer's load-balancing loss."""
        cfg = self.cfg
        h = apply_norm(cfg.norm, x, p, "ln_attn")
        q, k, v = attn_qkv(cfg, subtree(p, "attn"), h, positions)
        if mode == "decode":
            for name, t in self._cache_entries(k, v).items():
                kv[name].index_copy_(1, slot, t)
            if cfg.kv_quant:
                k_att = kv_dequantize(kv["k"], kv["k_scale"], x.dtype)
                v_att = kv_dequantize(kv["v"], kv["v_scale"], x.dtype)
            else:
                k_att, v_att = kv["k"], kv["v"]
            att = decode_attention(
                q, k_att, v_att, lengths, window=cfg.attn_window,
                positions=torch.arange(k_att.shape[1], device=x.device),
                impl=cfg.attn_impl)
        else:
            # context parallelism: query blocks over the "seq" axis (what
            # it resolves to under a sharding context; never more than one
            # way on one card)
            ways = axis_ways("seq") if cfg.cp_attn else 0
            att = attention(q, k, v, causal=True, window=cfg.attn_window,
                            impl=cfg.attn_impl, q_chunk=cfg.q_chunk,
                            cp_ways=ways, shard_fn=shard)
            if mode == "prefill":
                kv = self._cache_entries(k, v)
        B, S = att.shape[:2]
        wo = p["attn/o"].to(x.dtype)
        x = x + shard(att.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]),
                      ("batch", None, None))
        if cfg.sp_acts and mode == "train":
            # sequence-sharded residuals between blocks (Megatron-style)
            x = shard(x, ("batch", "seq", None))
        h2 = apply_norm(cfg.norm, x, p, "ln_mlp")
        aux = None
        if moe:
            y, aux = moe_apply(cfg, subtree(p, "moe"), h2, shard_fn=shard)
            if cfg.shared_expert:
                y = y + mlp_apply(cfg, subtree(p, "shared_mlp"), h2)
        else:
            y = mlp_apply(cfg, subtree(p, "mlp"), h2)
        x = x + shard(y, ("batch", None, None))
        if cfg.sp_acts and mode == "train":
            x = shard(x, ("batch", "seq", None))
        return x, aux, kv

    def _layers(self, params) -> list[tuple[dict, bool]]:
        """Every layer's (params, is MoE) in depth order, the cache's: in
        the grouped layout each group's dense layers, then its MoE
        layer."""
        G, dpg = self._layout()
        if dpg == 0:
            moe = bool(self.cfg.n_experts)
            return [(p, moe) for p in layer_slices(subtree(params, "layers"))]
        dense = layer_slices(subtree(params, "layers_dense"))
        moe = layer_slices(subtree(params, "layers_moe"))
        out = []
        for g in range(G):
            out += [(p, False) for p in dense[g * dpg:(g + 1) * dpg]]
            out.append((moe[g], True))
        return out

    def _trunk(self, params, x, positions, mode, cache=None):
        """The layer loop. Returns (x, the MoE layers' summed aux loss,
        per-layer cache entries in prefill mode, else None)."""
        cfg = self.cfg
        layers = self._layers(params)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if mode == "train":
            # one checkpointed unit per layer, per group in the grouped
            # layout
            per = self._layout()[1] + 1
            run = _maybe_remat(self._train_group, cfg.remat)
            for i in range(0, len(layers), per):
                x, a = run(layers[i:i + per], x, positions)
                aux = aux + a
            return x, aux, None
        dec = mode == "decode"
        slot = lengths = None
        names = [k for k in (cache or {}) if k != "pos"]
        if dec:
            kv_len = cache["k"].shape[2]
            pos = cache["pos"]
            write_pos = torch.remainder(pos, kv_len) if cfg.attn_window \
                else pos
            # the reference's clamped dynamic_update_slice
            slot = write_pos.clamp(max=kv_len - 1).long().reshape(1)
            lengths = (write_pos + 1).to(torch.int32).expand(x.shape[0])
            lengths = lengths.contiguous()
        kvs = []
        for i, (p, moe) in enumerate(layers):
            kv = {n: cache[n][i] for n in names} if dec else None
            x, a, kv = self._layer(p, x, positions, mode, moe, kv=kv,
                                   slot=slot, lengths=lengths)
            if a is not None:
                aux = aux + a
            kvs.append(kv)
        return x, aux, (kvs if mode == "prefill" else None)

    def _train_group(self, group, x, positions):
        """A training unit of layers: (x, their summed aux loss)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, moe in group:
            x, a, _ = self._layer(p, x, positions, "train", moe)
            if a is not None:
                aux = aux + a
        return x, aux

    def forward(self, params, batch):
        """Training/scoring forward: returns (hidden (B, S, D), the MoE
        layers' summed aux loss, 0 without them); ``cfg.remat`` checkpoints
        each layer (each group in the grouped layout)."""
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, aux, _ = self._trunk(params, x, positions, "train")
        x = apply_norm(self.cfg.norm, x, params, "ln_f")
        return x, aux

    # --------------------------------------------------------------- loss
    def _xent(self, params, h, batch):
        """Mean cross-entropy of ``h`` against ``batch["targets"]`` over the
        positions ``batch[self.loss_mask_key]`` marks (every position when
        the batch has none): the reference's chunked loss,
        ``cfg.loss_chunk``/``loss_impl``/``logits_softcap``."""
        from repro_torch.modeling.losses import chunked_softmax_xent

        cfg = self.cfg
        mask = batch.get(self.loss_mask_key)
        if mask is None:
            mask = torch.ones(batch["targets"].shape, dtype=torch.float32,
                              device=h.device)
        loss_sum, denom = chunked_softmax_xent(
            h, self._unembed(params).to(h.dtype), batch["targets"],
            mask.float(), chunk=cfg.loss_chunk, cap=cfg.logits_softcap,
            impl=cfg.loss_impl)
        return loss_sum / torch.clamp(denom, min=1.0)

    def loss(self, params, batch):
        """(loss, {"xent", "aux"}): the mean masked next-token cross-entropy,
        plus with MoE layers 0.01 times their aux loss over the number of
        groups (layers, in the plain layout)."""
        h, aux = self.forward(params, batch)
        xent = self._xent(params, h, batch)
        loss = xent
        if self.cfg.n_experts:
            loss = loss + 0.01 * aux / max(self._layout()[0], 1)
        return loss, {"xent": xent, "aux": aux}

    # ------------------------------------------------------------ serving
    def cache_shape(self, batch_size: int, cache_len: int) -> dict:
        """``{name: (shape, dtype)}`` of ``init_cache``'s tensors: with
        ``kv_quant`` int8 K/V and float32 scales, one per (slot, head)."""
        cfg = self.cfg
        kv_len = min(cache_len, cfg.attn_window) if cfg.attn_window \
            else cache_len
        shp = (cfg.n_layers, batch_size, kv_len, cfg.n_kv_heads, cfg.head_dim)
        kv_dt = torch.int8 if cfg.kv_quant else self.dtype
        out = {"k": (shp, kv_dt), "v": (shp, kv_dt), "pos": ((), torch.int32)}
        if cfg.kv_quant:
            out["k_scale"] = out["v_scale"] = (shp[:-1] + (1,), torch.float32)
        return out

    def cache_axes(self) -> dict:
        """Logical axes of ``cache_shape``'s tensors: the KV sequence axis
        carries the model parallelism when the KV heads cannot
        (flash-decode style)."""
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        out = {"k": kv, "v": kv, "pos": ()}
        if self.cfg.kv_quant:
            out["k_scale"] = out["v_scale"] = kv
        return out

    def init_cache(self, batch_size: int, cache_len: int, device=None) -> dict:
        return {name: torch.zeros(shape, dtype=dt, device=device)
                for name, (shape, dt) in
                self.cache_shape(batch_size, cache_len).items()}

    def prefill(self, params, batch, cache_len: int | None = None):
        """Process a full prompt (after its vision prefix, when the batch
        carries one); returns (last-token logits (B, V) float32, cache)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        S = x.shape[1]
        cache_len = cache_len or S
        positions = torch.arange(S, device=x.device)[None, :]
        x, _, kvs = self._trunk(params, x, positions, "prefill")
        x = apply_norm(cfg.norm, x, params, "ln_f")
        logits = logits_f32(x[:, -1, :], self._unembed(params).to(x.dtype))

        kv_len = min(cache_len, cfg.attn_window) if cfg.attn_window \
            else cache_len

        def fit(arr):  # (L, B, S, Hkv, D) -> (L, B, kv_len, Hkv, D)
            if kv_len >= S:
                return torch.nn.functional.pad(
                    arr, (0, 0, 0, 0, 0, kv_len - S))
            shift = (S - kv_len) % kv_len
            return torch.roll(arr[:, :, -kv_len:], shift, dims=2)

        cache = {name: fit(torch.stack([kv[name] for kv in kvs]))
                 for name in kvs[0]}
        # a fill on the device, not a copy from the host: the prefill is
        # captured in a CUDA graph on the card
        cache["pos"] = torch.full((), S, dtype=torch.int32, device=x.device)
        return logits, cache

    def decode_step(self, params, cache, batch):
        """One token for every sequence in the batch (uniform position).
        Writes the token's K/V into ``cache`` and advances ``cache["pos"]``
        in place; returns (logits (B, V) float32, cache)."""
        cfg = self.cfg
        x = shard(self._embed(params, batch["token"])[:, None, :],
                  ("batch", None, None))
        positions = cache["pos"].expand(x.shape[0], 1)
        x, _, _ = self._trunk(params, x, positions, "decode", cache=cache)
        x = apply_norm(cfg.norm, x, params, "ln_f")
        logits = logits_f32(x[:, 0, :], self._unembed(params).to(x.dtype))
        cache["pos"].add_(1)
        return logits, cache
