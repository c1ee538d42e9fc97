"""Mamba-2 LM (attention-free, SSD blocks): the port of
``repro.modeling.mamba``.

Its decode state is O(1) in the context length: per layer a float32
(heads, head_dim, state) SSD state and the last ``conv_width - 1`` inputs
of the causal conv. The layer loop is a Python loop over the stacked
parameters (the reference's ``lax.scan``); every prefill runs the SSD scan
kernel (K6) once per layer.

As in ``lm.py``, ``decode_step`` updates the cache in place (the SSD state
and the conv window of each layer, and ``cache["pos"]``): on the card a
serving executor replays the step from a CUDA graph over static buffers.
``prefill`` ignores ``cache_len``, as the reference does. ``loss`` is
``LM.loss``, inherited as in the reference; a training step runs each
layer's SSD through ``kernels/ssd_scan/ops.py::SSDScanFn``: K6 forward (and
again in the remat recompute), K6b backward (their plain versions on the
CPU).
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import shard
from repro_torch.modeling.layers import apply_norm, norm_specs
from repro_torch.modeling.lm import LM, _maybe_remat, logits_f32
from repro_torch.modeling.module import (
    ParamSpec,
    layer_slice,
    layer_slices,
    prefix_specs,
    stacked,
    subtree,
)
from repro_torch.modeling.ssd import ssd_block_apply, ssd_block_specs, ssd_dims

# parameters the reference uses in float32 (the norm scales inside
# ``rms_norm``; A and dt from ``a_log`` and ``dt_bias``): (parent, name)
# path endings a server keeps in float32
FLOAT32_PARAMS = {("ln", "scale"), ("ln_f", "scale"), ("norm", "scale"),
                  ("mixer", "a_log"), ("mixer", "dt_bias")}


class MambaLM(LM):
    """The SSM family. Stateless, like ``LM``: every method takes the flat
    parameter dict."""

    def layer_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        s: dict[str, ParamSpec] = {}
        s.update(prefix_specs("ln", norm_specs(cfg.norm, cfg.d_model)))
        s.update(prefix_specs("mixer", ssd_block_specs(cfg)))
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

    def serving_cast(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """A parameter as a server holds it: the norm scales, ``a_log`` and
        ``dt_bias`` stay float32 (the reference uses them in float32); every
        other parameter is cast to ``cfg.dtype``, as each use would cast
        it."""
        if tuple(path.split("/")[-2:]) in FLOAT32_PARAMS:
            return t
        return t.to(self.dtype)

    def _trunk(self, params, x, cache=None):
        """The layer loop of prefill and decode. Prefill (``cache`` None)
        returns the per-layer (state, conv window); decode updates ``cache``
        in place."""
        cfg = self.cfg
        layers = subtree(params, "layers")
        out = []
        for i in range(cfg.n_layers):
            p = layer_slice(layers, i)
            st = cache["state"][i] if cache is not None else None
            cv = cache["conv"][i] if cache is not None else None
            h = apply_norm(cfg.norm, x, p, "ln")
            y, st, cv = ssd_block_apply(cfg, subtree(p, "mixer"), h, state=st,
                                        conv_state=cv, impl=cfg.attn_impl)
            x = x + shard(y, ("batch", None, None))
            out.append((st, cv))
        return apply_norm(cfg.norm, x, params, "ln_f"), out

    def _train_layer(self, p, x):
        h = apply_norm(self.cfg.norm, x, p, "ln")
        y, _, _ = ssd_block_apply(self.cfg, subtree(p, "mixer"), h,
                                  impl=self.cfg.attn_impl)
        return x + shard(y, ("batch", None, None))

    def forward(self, params, batch):
        """Training/scoring forward: returns (hidden (B, S, D), aux_loss =
        0); ``cfg.remat`` checkpoints each layer."""
        x = self._embed_inputs(params, batch)
        layer = _maybe_remat(self._train_layer, self.cfg.remat)
        for p in layer_slices(subtree(params, "layers")):
            x = layer(p, x)
        x = apply_norm(self.cfg.norm, x, params, "ln_f")
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    # ------------------------------------------------------------ serving
    def cache_shape(self, batch_size: int, cache_len: int) -> dict:
        """``{name: (shape, dtype)}`` of ``init_cache``'s tensors; the state
        does not grow with ``cache_len``."""
        cfg = self.cfg
        d_inner, nh, hd, ds = ssd_dims(cfg)
        L = cfg.n_layers
        return {"state": ((L, batch_size, nh, hd, ds), torch.float32),
                "conv": ((L, batch_size, cfg.conv_width - 1, d_inner + 2 * ds),
                         self.dtype),
                "pos": ((), torch.int32)}

    def cache_axes(self) -> dict:
        """Logical axes of ``cache_shape``'s tensors."""
        return {"state": ("layers", "batch", "ssm_heads", None, None),
                "conv": ("layers", "batch", None, "rnn"),
                "pos": ()}

    def prefill(self, params, batch, cache_len: int | None = None):
        """Process a full prompt; returns (last-token logits (B, V) float32,
        cache)."""
        x, out = self._trunk(params, self._embed_inputs(params, batch))
        logits = logits_f32(x[:, -1, :], self._unembed(params).to(x.dtype))
        cache = {"state": torch.stack([st for st, _ in out]),
                 "conv": torch.stack([cv for _, cv in out]).to(self.dtype),
                 # a fill on the device (the prefill is captured in a CUDA
                 # graph on the card)
                 "pos": torch.full((), x.shape[1], dtype=torch.int32,
                                   device=x.device)}
        return logits, cache

    def decode_step(self, params, cache, batch):
        """One token for every sequence in the batch. Updates the SSD states,
        the conv windows and ``cache["pos"]`` in place; returns (logits
        (B, V) float32, cache)."""
        x = self._embed(params, batch["token"])[:, None, :]
        x, _ = self._trunk(params, x, cache=cache)
        logits = logits_f32(x[:, 0, :], self._unembed(params).to(x.dtype))
        cache["pos"].add_(1)
        return logits, cache
