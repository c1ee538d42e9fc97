"""Architecture registry: the 10 assigned configs + smoke-test reductions."""

from __future__ import annotations

from dataclasses import replace

from repro_torch.configs.base import (
    ArchConfig,
    ShapeConfig,
    SHAPES,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
    applicable_shapes,
)
from repro_torch.configs import (
    gemma_2b,
    olmo_1b,
    nemotron_4_340b,
    llama3_2_1b,
    llama4_maverick,
    olmoe_1b_7b,
    internvl2_26b,
    recurrentgemma_9b,
    hubert_xlarge,
    mamba2_780m,
)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        gemma_2b, olmo_1b, nemotron_4_340b, llama3_2_1b, llama4_maverick,
        olmoe_1b_7b, internvl2_26b, recurrentgemma_9b, hubert_xlarge,
        mamba2_780m,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (one fwd/train step)."""
    cfg = get_config(name)
    kw = dict(
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=64,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=128,
        q_chunk=16,
        loss_chunk=16,
        moe_group=16,
        remat="none",
        dtype="float32",
    )
    if cfg.n_heads:
        ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(4 // min(ratio, 4), 1)
        kw["head_dim"] = 16
    if cfg.n_experts:
        kw["n_experts"] = 4
        kw["top_k"] = min(cfg.top_k, 2)
        kw["d_ff_expert"] = 64
    if cfg.family == "hybrid":
        kw["d_rnn"] = 64
        kw["attn_window"] = 16
    if cfg.family == "ssm":
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 8
        kw["ssm_chunk"] = 8
    if cfg.vision_tokens:
        kw["vision_tokens"] = 8
        kw["vision_feat_dim"] = 32
    if cfg.frame_feat_dim:
        kw["frame_feat_dim"] = 16
    return replace(cfg, **kw)


__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "ARCHS",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "get_config", "smoke_config", "applicable_shapes",
]
