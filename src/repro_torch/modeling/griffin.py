"""Griffin-style hybrid LM (RecurrentGemma): RG-LRU blocks and local
attention, the port of ``repro.modeling.griffin``.

The layer pattern (rec, rec, attn) repeats; for 38 layers that is 12 full
groups plus a (rec, rec) tail, 26 recurrent and 12 local-attention layers.
The parameters are stacked as the reference stacks them, recurrent layers
under ``rec_layers/`` (n_rec, ...) and attention layers under
``attn_layers/`` (n_attn, ...), so the JAX package's parameters cross over
by name (``modeling/convert.py``). The layers run in a plain Python loop
over the pattern (the reference scans over the groups and unrolls the
tail; the order of the layers is the same).

Every prefill runs the RG-LRU recurrence through the linear-scan kernel
(K3) and the local attention through the flash-attention kernel (K4, with
the window); every decode step runs the attention through the flash-decode
kernel (K5). The local-attention KV cache is a ring buffer of
``min(cache_len, attn_window)`` slots (keys stored after RoPE): a prefill of
S tokens keeps the last ``kv_len`` of them, rolled so that position ``t``
sits in slot ``t % kv_len``; a decode step writes slot ``pos % kv_len`` and
attends over ``min(pos + 1, kv_len)`` slots with no window filter (every
resident slot lies within the window by construction), as the reference
calls its decode attention.

As in ``lm.py``, ``decode_step`` updates the cache in place (the RG-LRU
states and conv windows, the token's K/V slot, ``cache["pos"]``), with the
slot and the lengths computed on the device: a serving executor replays the
step from a CUDA graph over static buffers.

``loss`` is the chunked cross-entropy, as in ``lm.py``; ``cfg.remat``
checkpoints each training layer (the reference checkpoints each (rec, rec,
attn) group's body and runs the tail unchecked: the same values). A
training step runs the recurrence through ``LinearScanFn`` (K3 forward, K3b
backward) and the local attention through ``FlashAttentionFn`` (K4, K4b);
on the CPU their plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import shard
from repro_torch.modeling.attention import attention, decode_attention
from repro_torch.modeling.layers import apply_norm, norm_specs
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
    layer_slice,
    layer_slices,
    prefix_specs,
    stacked,
    subtree,
)
from repro_torch.modeling.rglru import rglru_block_apply, rglru_block_specs

# parameters the reference uses in float32 (the norm scales inside
# ``rms_norm``; the RG-LRU's gate weights and biases and ``lambda``, which
# it never casts): path endings a server keeps in float32
FLOAT32_PARAMS = {("gate_a", "w"), ("gate_a", "b"), ("gate_x", "w"),
                  ("gate_x", "b"), ("mixer", "lambda")}


def layer_kinds(cfg) -> list[str]:
    """The kind of every layer in order ("rec" or "attn"): the pattern
    repeated, its last group cut to ``n_layers`` (the reference's full
    groups and tail)."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


class GriffinLM(LM):
    """The hybrid family. Stateless, like ``LM``: every method takes the
    flat parameter dict."""

    # ------------------------------------------------------------- params
    def rec_layer_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        s: dict[str, ParamSpec] = {}
        s.update(prefix_specs("ln_mix", norm_specs(cfg.norm, cfg.d_model)))
        s.update(prefix_specs("mixer", rglru_block_specs(cfg)))
        s.update(prefix_specs("ln_mlp", norm_specs(cfg.norm, cfg.d_model)))
        s.update(prefix_specs("mlp", mlp_specs(cfg, cfg.d_ff)))
        return s

    def attn_layer_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        s: dict[str, ParamSpec] = {}
        s.update(prefix_specs("ln_mix", norm_specs(cfg.norm, cfg.d_model)))
        s.update(prefix_specs("attn", attn_specs(cfg)))
        s.update(prefix_specs("ln_mlp", norm_specs(cfg.norm, cfg.d_model)))
        s.update(prefix_specs("mlp", mlp_specs(cfg, cfg.d_ff)))
        return s

    def param_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        kinds = layer_kinds(cfg)
        specs: dict[str, ParamSpec] = {
            "embed/w": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                                 init="embed"),
        }
        specs.update(prefix_specs(
            "rec_layers", {k: stacked(v, kinds.count("rec"))
                           for k, v in self.rec_layer_specs().items()}))
        specs.update(prefix_specs(
            "attn_layers", {k: stacked(v, kinds.count("attn"))
                            for k, v in self.attn_layer_specs().items()}))
        specs.update(prefix_specs("ln_f", norm_specs(cfg.norm, cfg.d_model)))
        if not cfg.tie_embeddings:
            specs["unembed/w"] = ParamSpec(
                (cfg.d_model, cfg.vocab), ("embed", "vocab"),
                scale=cfg.d_model ** -0.5)
        return specs

    def serving_cast(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """A parameter as a server holds it: the norm scales and the RG-LRU's
        gate weights, gate biases and ``lambda`` stay float32 (the reference
        uses them in float32); every other parameter is cast to
        ``cfg.dtype``, as each use would cast it."""
        parts = tuple(path.split("/"))
        if parts[-2].startswith("ln_") or parts[-2:] in FLOAT32_PARAMS:
            return t
        return t.to(self.dtype)

    # ------------------------------------------------------------- layers
    def _rec_layer(self, p, x, state=None, conv=None):
        cfg = self.cfg
        h = apply_norm(cfg.norm, x, p, "ln_mix")
        mix, st, cv = rglru_block_apply(cfg, subtree(p, "mixer"), h,
                                        state=state, conv_state=conv,
                                        impl=cfg.attn_impl)
        # no sequence sharding here: the RG-LRU scan is sequential in S
        x = x + shard(mix, ("batch", None, None))
        h2 = apply_norm(cfg.norm, x, p, "ln_mlp")
        return x + shard(mlp_apply(cfg, subtree(p, "mlp"), h2),
                         ("batch", None, None)), st, cv

    def _attn_layer(self, p, x, positions, mode, kc=None, vc=None,
                    slot=None, lengths=None):
        """One local-attention layer. In decode mode ``kc``/``vc`` are this
        layer's ring buffers (B, kv_len, Hkv, D), written in place at
        ``slot``; in prefill mode the ring is built from the prompt's K/V."""
        cfg = self.cfg
        h = apply_norm(cfg.norm, x, p, "ln_mix")
        q, k, v = attn_qkv(cfg, subtree(p, "attn"), h, positions)
        W = cfg.attn_window
        if mode == "decode":
            kc.index_copy_(1, slot, k)
            vc.index_copy_(1, slot, v)
            att = decode_attention(q, kc, vc, lengths, impl=cfg.attn_impl)
        else:
            if cfg.cp_attn:
                q = shard(q, ("batch", "seq", None, None))
            att = attention(q, k, v, causal=True, window=W,
                            impl=cfg.attn_impl)
            if mode == "prefill":
                S = k.shape[1]
                kv_len = min(W, S) if W else S
                # ring-buffer convention: slot = position % kv_len
                shift = (S - kv_len) % kv_len
                kc = torch.roll(k[:, -kv_len:], shift, dims=1)
                vc = torch.roll(v[:, -kv_len:], shift, dims=1)
        B, S = att.shape[:2]
        wo = p["attn/o"].to(x.dtype)
        x = x + shard(att.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]),
                      ("batch", None, None))
        if cfg.sp_acts and mode == "train":
            x = shard(x, ("batch", "seq", None))
        h2 = apply_norm(cfg.norm, x, p, "ln_mlp")
        return x + shard(mlp_apply(cfg, subtree(p, "mlp"), h2),
                         ("batch", None, None)), kc, vc

    def _run(self, params, x, positions, mode, cache=None):
        """The layer loop, shared by forward, prefill and decode. Prefill
        returns the new cache's (state, conv, k, v) stacks; decode updates
        ``cache`` in place; forward returns no cache."""
        rec_p = subtree(params, "rec_layers")
        attn_p = subtree(params, "attn_layers")
        dec = mode == "decode"
        slot = lengths = None
        if dec:
            kv_len = cache["k"].shape[2]
            pos = cache["pos"]
            slot = torch.remainder(pos, kv_len).long().reshape(1)
            lengths = torch.clamp(pos + 1, max=kv_len).to(torch.int32)
            lengths = lengths.expand(x.shape[0]).contiguous()
        sts, cvs, kcs, vcs = [], [], [], []
        ri = ai = 0
        if mode == "train":
            rec = _maybe_remat(lambda p, x: self._rec_layer(p, x)[0],
                               self.cfg.remat)
            att = _maybe_remat(
                lambda p, x: self._attn_layer(p, x, positions, mode)[0],
                self.cfg.remat)
            rec_ls, attn_ls = layer_slices(rec_p), layer_slices(attn_p)
            for kind in layer_kinds(self.cfg):
                if kind == "rec":
                    x = rec(rec_ls[ri], x)
                    ri += 1
                else:
                    x = att(attn_ls[ai], x)
                    ai += 1
            return x, None
        for kind in layer_kinds(self.cfg):
            if kind == "rec":
                x, st, cv = self._rec_layer(
                    layer_slice(rec_p, ri), x,
                    state=cache["state"][ri] if dec else None,
                    conv=cache["conv"][ri] if dec else None)
                sts.append(st)
                cvs.append(cv)
                ri += 1
            else:
                x, kc, vc = self._attn_layer(
                    layer_slice(attn_p, ai), x, positions, mode,
                    kc=cache["k"][ai] if dec else None,
                    vc=cache["v"][ai] if dec else None,
                    slot=slot, lengths=lengths)
                kcs.append(kc)
                vcs.append(vc)
                ai += 1
        if mode != "prefill":
            return x, None
        return x, {"state": torch.stack(sts), "conv": torch.stack(cvs),
                   "k": torch.stack(kcs), "v": torch.stack(vcs)}

    def forward(self, params, batch):
        """Scoring forward: returns (hidden (B, S, D), aux_loss = 0)."""
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _ = self._run(params, x, positions, "train")
        x = apply_norm(self.cfg.norm, x, params, "ln_f")
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params, batch):
        """(loss, {"xent"}): the mean masked next-token cross-entropy, as
        the reference's ``GriffinLM.loss`` returns it."""
        h, _ = self.forward(params, batch)
        loss = self._xent(params, h, batch)
        return loss, {"xent": loss}

    # ------------------------------------------------------------ serving
    def cache_shape(self, batch_size: int, cache_len: int) -> dict:
        """``{name: (shape, dtype)}`` of ``init_cache``'s tensors: the RG-LRU
        states and conv windows do not grow with ``cache_len``, the rings
        hold at most ``attn_window`` slots."""
        cfg = self.cfg
        n_rec, n_attn = (layer_kinds(cfg).count(k) for k in ("rec", "attn"))
        kv_len = min(cache_len, cfg.attn_window) if cfg.attn_window \
            else cache_len
        kv = (n_attn, batch_size, kv_len, cfg.n_kv_heads, cfg.head_dim)
        return {"state": ((n_rec, batch_size, cfg.d_rnn), torch.float32),
                "conv": ((n_rec, batch_size, cfg.conv_width - 1, cfg.d_rnn),
                         self.dtype),
                "k": (kv, self.dtype), "v": (kv, self.dtype),
                "pos": ((), torch.int32)}

    def cache_axes(self) -> dict:
        """Logical axes of ``cache_shape``'s tensors."""
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        return {"state": ("layers", "batch", "rnn"),
                "conv": ("layers", "batch", None, "rnn"),
                "k": kv, "v": kv, "pos": ()}

    def prefill(self, params, batch, cache_len: int | None = None):
        """Process a full prompt; returns (last-token logits (B, V) float32,
        cache). The rings are zero-padded to ``min(cache_len, attn_window)``
        slots when that is more than the prompt fills."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        S = x.shape[1]
        cache_len = cache_len or S
        positions = torch.arange(S, device=x.device)[None, :]
        x, cache = self._run(params, x, positions, "prefill")
        x = apply_norm(cfg.norm, x, params, "ln_f")
        logits = logits_f32(x[:, -1, :], self._unembed(params).to(x.dtype))
        kv_len = min(cache_len, cfg.attn_window) if cfg.attn_window \
            else cache_len
        cur = cache["k"].shape[2]
        if kv_len > cur:
            for key in ("k", "v"):
                cache[key] = torch.nn.functional.pad(
                    cache[key], (0, 0, 0, 0, 0, kv_len - cur))
        cache["conv"] = cache["conv"].to(self.dtype)
        # a fill on the device, not a copy from the host: the prefill is
        # captured in a CUDA graph on the card
        cache["pos"] = torch.full((), S, dtype=torch.int32, device=x.device)
        return logits, cache

    def decode_step(self, params, cache, batch):
        """One token for every sequence in the batch (uniform position).
        Updates the RG-LRU states and conv windows, writes the token's K/V
        into slot ``pos % kv_len`` of every ring and advances
        ``cache["pos"]``, all in place; returns (logits (B, V) float32,
        cache)."""
        cfg = self.cfg
        x = self._embed(params, batch["token"])[:, None, :]
        positions = cache["pos"].expand(x.shape[0], 1)
        x, _ = self._run(params, x, positions, "decode", cache=cache)
        x = apply_norm(cfg.norm, x, params, "ln_f")
        logits = logits_f32(x[:, 0, :], self._unembed(params).to(x.dtype))
        cache["pos"].add_(1)
        return logits, cache
