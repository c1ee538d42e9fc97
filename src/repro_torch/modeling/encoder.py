"""Encoder-only audio model (the HuBERT-XL backbone): the port of
``repro.modeling.encoder``.

The CNN waveform frontend is a stub, as in the reference: a batch carries
precomputed frame features ``frames`` (B, S, frame_feat_dim); the model
applies the learned feature projection, blends a learned mask embedding
into the masked frames (``mask`` (B, S), 1 where a frame is masked), adds
sinusoidal positions and runs a bidirectional transformer encoder (no
RoPE: ``pos_emb="sinusoidal"``). Training is masked prediction over the
codebook (``vocab``): the cross-entropy of the frame logits against
``targets`` (B, S) at the masked frames only, at every frame when the
batch has no mask.

Operation for operation as the reference computes it, with the decoder's
conventions (``modeling/lm.py``): the model is stateless and takes its flat
parameter dict on every call; parameters are float32 and cast to
``cfg.dtype`` where they are used (the frontend, ``mask_emb`` and the head
too), norms compute in float32; the layers are walked by a Python loop over
``layer_slices`` (the reference's ``lax.scan``), each training layer under
``cfg.remat`` (``_maybe_remat``): under ``"full"`` a layer's forward runs
again in the backward pass, so its attention launches K4 twice per step
and K4b once. The attention is non-causal and goes through K4
(``modeling/attention.py``), which keeps the probabilities in float32
before the P·V product where the reference's XLA path rounds them to
``cfg.dtype``, so in bf16 the two differ slightly; the reference's
``q_chunk`` shapes its chunked XLA path, which the port does not have.

Encoder-only: ``encode`` (and ``prefill``, which the serving steps call)
returns float32 logits for every frame, and there is no decode step.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import shard
from repro_torch.modeling.attention import attention
from repro_torch.modeling.layers import (
    apply_norm,
    norm_specs,
    sinusoidal_positions,
)
from repro_torch.modeling.lm import (
    LM,
    _maybe_remat,
    attn_qkv,
    attn_specs,
    logits_f32,
    mlp_apply,
    mlp_specs,
)
from repro_torch.modeling.module import (
    ParamSpec,
    layer_slices,
    prefix_specs,
    stacked,
    subtree,
)


class AudioEncoder(LM):
    """The encoder. Like ``LM`` an ``nn.Module`` without registered
    parameters: every method takes the flat parameter dict."""

    loss_mask_key = "mask"

    # ------------------------------------------------------------- params
    def layer_specs(self, moe: bool | None = None) -> dict[str, ParamSpec]:
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
            "frontend/w": ParamSpec((cfg.frame_feat_dim, cfg.d_model),
                                    (None, "embed")),
            "frontend/b": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
            "mask_emb": ParamSpec((cfg.d_model,), ("embed",), init="embed",
                                  scale=0.02),
        }
        specs.update(prefix_specs(
            "layers", {k: stacked(v, cfg.n_layers)
                       for k, v in self.layer_specs().items()}))
        specs.update(prefix_specs("ln_f", norm_specs(cfg.norm, cfg.d_model)))
        specs["head/w"] = ParamSpec((cfg.d_model, cfg.vocab),
                                    ("embed", "vocab"),
                                    scale=cfg.d_model ** -0.5)
        return specs

    def _unembed(self, params):
        return params["head/w"]

    # ------------------------------------------------------------ forward
    def _layer(self, p, x):
        """One encoder layer; ``p`` holds its (unstacked) params."""
        cfg = self.cfg
        h = apply_norm(cfg.norm, x, p, "ln_attn")
        q, k, v = attn_qkv(cfg, subtree(p, "attn"), h, None)  # no RoPE
        att = attention(q, k, v, causal=False, window=0, impl=cfg.attn_impl)
        B, S = att.shape[:2]
        wo = p["attn/o"].to(x.dtype)
        x = x + shard(att.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]),
                      ("batch", None, None))
        h2 = apply_norm(cfg.norm, x, p, "ln_mlp")
        return x + shard(mlp_apply(cfg, subtree(p, "mlp"), h2),
                         ("batch", None, None))

    def forward(self, params, batch):
        """(hidden (B, S, D) after ``ln_f``, a float32 zero: the encoder has
        no aux loss). ``batch["frames"]`` (B, S, frame_feat_dim), with an
        optional ``batch["mask"]`` (B, S)."""
        cfg = self.cfg
        dt = self.dtype
        x = (batch["frames"].to(dt) @ params["frontend/w"].to(dt)
             + params["frontend/b"].to(dt))
        if "mask" in batch:
            m = batch["mask"].to(dt)[..., None]
            x = x * (1.0 - m) + params["mask_emb"].to(dt) * m
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, dt,
                                     x.device)[None]
        x = shard(x, ("batch", None, None))
        run = _maybe_remat(self._layer, cfg.remat)
        for p in layer_slices(subtree(params, "layers")):
            x = run(p, x)
        x = apply_norm(cfg.norm, x, params, "ln_f")
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    # --------------------------------------------------------------- loss
    def loss(self, params, batch):
        """(loss, {"xent": loss}): the masked-prediction cross-entropy over
        the frames ``batch["mask"]`` marks (``LM._xent`` with the encoder's
        mask key and head; hubert-xlarge has no logits softcap)."""
        h, _ = self.forward(params, batch)
        loss = self._xent(params, h, batch)
        return loss, {"xent": loss}

    # ------------------------------------------------------------ serving
    def encode(self, params, batch):
        """Inference forward: float32 frame logits (B, S, vocab) with
        float32 accumulation from ``cfg.dtype`` operands."""
        h, _ = self.forward(params, batch)
        B, S, D = h.shape
        return logits_f32(h.reshape(B * S, D),
                          self._unembed(params).to(h.dtype)).reshape(B, S, -1)

    def prefill(self, params, batch, cache_len: int | None = None):
        """The serving steps' entry: (``encode``'s logits, None); the
        encoder keeps no cache."""
        return self.encode(params, batch), None

    def decode_step(self, params, cache, batch):
        raise NotImplementedError(
            "encoder-only architecture has no decode step")
