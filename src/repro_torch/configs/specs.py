"""``input_specs``: ``meta`` tensor stand-ins for every model input (the
port of ``repro.configs.specs``, whose ShapeDtypeStructs these replace).

Nothing is allocated: the launch layer builds its cells and the dry run
counts its steps against these. For decode cells the spec holds the
KV/state cache of ``seq_len`` entries (from the model's ``cache_shape``,
whose entries are ``(shape, dtype)`` pairs) plus the one-token batch.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.modeling.registry import build_model


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch(cfg: ArchConfig, B: int, S: int, with_targets: bool):
    specs: dict[str, torch.Tensor] = {}
    i32, f32 = torch.int32, torch.float32
    if cfg.family == "audio":
        specs["frames"] = meta((B, S, cfg.frame_feat_dim), f32)
        if with_targets:
            specs["mask"] = meta((B, S), f32)
            specs["targets"] = meta((B, S), i32)
        return specs
    if cfg.family == "vlm":
        V = cfg.vision_tokens
        specs["tokens"] = meta((B, S - V), i32)
        specs["vision_embeds"] = meta((B, V, cfg.vision_feat_dim), f32)
    else:
        specs["tokens"] = meta((B, S), i32)
    if with_targets:
        specs["targets"] = meta((B, S), i32)
        specs["loss_mask"] = meta((B, S), f32)
    return specs


def input_specs(cfg: ArchConfig, shape: ShapeConfig):
    """(kind, specs), ``specs`` matching the step function's signature:

    - train:   {batch}                      for train_step(params, opt, batch)
    - prefill: {batch}                      for prefill_step(params, batch)
    - decode:  {batch: {token}, cache: ...} for decode_step(params, cache,
      batch)
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return "train", {"batch": _token_batch(cfg, B, S, with_targets=True)}
    if shape.kind == "prefill":
        return "prefill", {"batch": _token_batch(cfg, B, S,
                                                 with_targets=False)}
    if shape.kind == "decode":
        model = build_model(cfg)
        cache = {name: meta(shp, dt)
                 for name, (shp, dt) in model.cache_shape(B, S).items()}
        return "decode", {"cache": cache,
                          "batch": {"token": meta((B,), torch.int32)}}
    raise ValueError(f"unknown shape kind {shape.kind!r}")
