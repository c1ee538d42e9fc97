"""Decoder-only LM, the dense family: the port of ``repro.modeling.lm``.

One implementation parameterized by ``ArchConfig``, operation for operation
as the reference computes it: GQA/MQA/MHA attention with RoPE (optionally
local-windowed), gated (SwiGLU/GeGLU) or plain (squared-ReLU/GeLU) MLPs,
stacked per-layer parameters walked by a Python loop (the reference's
``lax.scan``), prefill (cache build) and single-token decode.

The model is stateless: like the reference it takes its flat parameter dict
``{path: tensor}`` on every call, so the same object serves float32 masters,
an executor's bf16 casts and parameters carried over from the JAX package
(``modeling/convert.py``). Parameters are float32 (``cfg.param_dtype``) and
are cast to ``cfg.dtype`` where they are used (a no-op for a parameter that
is already in that dtype); norm scales are used in float32; the logits are
float32 with float32 accumulation from ``cfg.dtype`` operands.

Serving trap kept on purpose: the reference writes a decode step's K/V with
``lax.dynamic_update_slice``, which clamps the start so the update fits. An
executor that decodes past its cache therefore overwrites the last slot at
every step, and the step's valid length ``pos + 1`` runs past the cache, so
every slot stays valid. The port writes at ``min(pos, kv_len - 1)`` and
hands the flash-decode kernel the same length.

``loss`` is the chunked cross-entropy (``modeling/losses.py``), and
``cfg.remat`` checkpoints each training layer (``_maybe_remat``): under
``"full"`` a layer's forward runs again in the backward pass, so its
attention launches K4 twice per step and its backward K4b once.

``decode_step`` writes the new K/V into ``cache`` and advances
``cache["pos"]`` in place (the JAX step returns a new cache): on the card a
serving executor replays the step from a CUDA graph over static buffers,
and the clamp, the write and the lengths are computed on the device.

Not in this slice, raising ``NotImplementedError``: MoE layers (with the
grouped ``moe_every`` layout), the vision prefix and the int8 KV cache.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import kernels
from repro_torch.modeling.attention import attention, decode_attention
from repro_torch.modeling.layers import (
    activation,
    apply_norm,
    apply_rope,
    is_gated,
    norm_specs,
)
from repro_torch.modeling.module import (
    ParamSpec,
    init_params,
    layer_slice,
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
    """The dense decoder. An ``nn.Module`` without registered parameters:
    every method takes the flat parameter dict, as the reference does."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers (and the grouped moe_every layout) "
                "come with the port's MoE/VLM slice")
        if cfg.vision_feat_dim or cfg.vision_tokens:
            raise NotImplementedError(
                f"{cfg.name}: the vision prefix comes with the port's MoE/VLM "
                "slice")
        if cfg.kv_quant:
            raise NotImplementedError(
                f"{cfg.name}: the int8 KV cache comes with a later serving "
                "slice of the port")
        self.cfg = cfg

    # ------------------------------------------------------------- params
    def layer_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        s: dict[str, ParamSpec] = {}
        s.update(prefix_specs("ln_attn", norm_specs(cfg.norm, cfg.d_model)))
        s.update(prefix_specs("attn", attn_specs(cfg)))
        s.update(prefix_specs("ln_mlp", norm_specs(cfg.norm, cfg.d_model)))
        s.update(prefix_specs("mlp", mlp_specs(cfg, cfg.d_ff)))
        return s

    def param_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        specs: dict[str, ParamSpec] = {
            "embed/w": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                                 init="embed"),
        }
        specs.update(prefix_specs(
            "layers", {k: stacked(v, cfg.n_layers)
                       for k, v in self.layer_specs().items()}))
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
        ``cfg.dtype`` (as each use would cast it), norm parameters kept in
        float32 (they are used in float32)."""
        if path.split("/")[-2].startswith("ln_"):
            return t
        return t.to(self.dtype)

    def param_count(self) -> int:
        return param_count(self.param_specs())

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

    def _layer(self, p, x, positions, mode, kc=None, vc=None, slot=None,
               lengths=None):
        """One transformer layer. ``p`` holds this layer's (unstacked)
        params; in decode mode ``kc``/``vc`` are this layer's cache slices
        (B, kv_len, Hkv, D), written in place at ``slot``."""
        cfg = self.cfg
        h = apply_norm(cfg.norm, x, p, "ln_attn")
        q, k, v = attn_qkv(cfg, subtree(p, "attn"), h, positions)
        if mode == "decode":
            kc.index_copy_(1, slot, k)
            vc.index_copy_(1, slot, v)
            att = decode_attention(
                q, kc, vc, lengths, window=cfg.attn_window,
                positions=torch.arange(kc.shape[1], device=kc.device),
                impl=cfg.attn_impl)
        else:
            att = attention(q, k, v, causal=True, window=cfg.attn_window,
                            impl=cfg.attn_impl)
            kc, vc = k, v
        B, S = att.shape[:2]
        wo = p["attn/o"].to(x.dtype)
        x = x + att.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
        h2 = apply_norm(cfg.norm, x, p, "ln_mlp")
        x = x + mlp_apply(cfg, subtree(p, "mlp"), h2)
        return x, kc, vc

    def _trunk(self, params, x, positions, mode, cache=None):
        """The layer loop. Returns (x, per-layer (k, v) or None)."""
        layers = subtree(params, "layers")
        dec = mode == "decode"
        slot = lengths = None
        if dec:
            kv_len = cache["k"].shape[2]
            pos = cache["pos"]
            write_pos = torch.remainder(pos, kv_len) if self.cfg.attn_window \
                else pos
            # the reference's clamped dynamic_update_slice
            slot = write_pos.clamp(max=kv_len - 1).long().reshape(1)
            lengths = (write_pos + 1).to(torch.int32).expand(x.shape[0])
            lengths = lengths.contiguous()
        if mode == "train":
            train_layer = _maybe_remat(self._train_layer, self.cfg.remat)
            for p in layer_slices(layers):
                x = train_layer(p, x, positions)
            return x, None
        kvs = []
        for i in range(self.cfg.n_layers):
            kc = cache["k"][i] if dec else None
            vc = cache["v"][i] if dec else None
            x, kc, vc = self._layer(layer_slice(layers, i), x, positions, mode,
                                    kc=kc, vc=vc, slot=slot, lengths=lengths)
            kvs.append((kc, vc))
        return x, (kvs if mode == "prefill" else None)

    def _train_layer(self, p, x, positions):
        return self._layer(p, x, positions, "train")[0]

    def forward(self, params, batch):
        """Training/scoring forward: returns (hidden (B, S, D), aux_loss =
        0); ``cfg.remat`` checkpoints each layer."""
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _ = self._trunk(params, x, positions, "train")
        x = apply_norm(self.cfg.norm, x, params, "ln_f")
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    # --------------------------------------------------------------- loss
    def _xent(self, params, h, batch):
        """Mean masked cross-entropy of ``h`` against ``batch["targets"]``
        (the reference's chunked loss, ``cfg.loss_chunk``/``loss_impl``/
        ``logits_softcap``)."""
        from repro_torch.modeling.losses import chunked_softmax_xent

        cfg = self.cfg
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(batch["targets"].shape, dtype=torch.float32,
                              device=h.device)
        loss_sum, denom = chunked_softmax_xent(
            h, self._unembed(params).to(h.dtype), batch["targets"],
            mask.float(), chunk=cfg.loss_chunk, cap=cfg.logits_softcap,
            impl=cfg.loss_impl)
        return loss_sum / torch.clamp(denom, min=1.0)

    def loss(self, params, batch):
        """(loss, {"xent", "aux"}): the mean masked next-token cross-entropy
        (``aux`` is 0: no MoE in this family yet)."""
        h, aux = self.forward(params, batch)
        loss = self._xent(params, h, batch)
        return loss, {"xent": loss, "aux": aux}

    # ------------------------------------------------------------ serving
    def cache_shape(self, batch_size: int, cache_len: int) -> dict:
        """``{name: (shape, dtype)}`` of ``init_cache``'s tensors."""
        cfg = self.cfg
        kv_len = min(cache_len, cfg.attn_window) if cfg.attn_window \
            else cache_len
        shp = (cfg.n_layers, batch_size, kv_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (shp, self.dtype), "v": (shp, self.dtype),
                "pos": ((), torch.int32)}

    def init_cache(self, batch_size: int, cache_len: int, device=None) -> dict:
        return {name: torch.zeros(shape, dtype=dt, device=device)
                for name, (shape, dt) in
                self.cache_shape(batch_size, cache_len).items()}

    def prefill(self, params, batch, cache_len: int | None = None):
        """Process a full prompt; returns (last-token logits (B, V) float32,
        cache)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        S = x.shape[1]
        cache_len = cache_len or S
        positions = torch.arange(S, device=x.device)[None, :]
        x, kvs = self._trunk(params, x, positions, "prefill")
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

        cache = {"k": fit(torch.stack([k for k, _ in kvs])),
                 "v": fit(torch.stack([v for _, v in kvs])),
                 # a fill on the device, not a copy from the host: the
                 # prefill is captured in a CUDA graph on the card
                 "pos": torch.full((), S, dtype=torch.int32,
                                   device=x.device)}
        return logits, cache

    def decode_step(self, params, cache, batch):
        """One token for every sequence in the batch (uniform position).
        Writes the token's K/V into ``cache`` and advances ``cache["pos"]``
        in place; returns (logits (B, V) float32, cache)."""
        cfg = self.cfg
        x = self._embed(params, batch["token"])[:, None, :]
        positions = cache["pos"].expand(x.shape[0], 1)
        x, _ = self._trunk(params, x, positions, "decode", cache=cache)
        x = apply_norm(cfg.norm, x, params, "ln_f")
        logits = logits_f32(x[:, 0, :], self._unembed(params).to(x.dtype))
        cache["pos"].add_(1)
        return logits, cache
