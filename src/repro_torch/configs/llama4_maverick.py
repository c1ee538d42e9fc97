"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
GQA kv=8, early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,             # shared-expert / dense dims
    vocab=202048,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=500000.0,
    n_experts=128,
    top_k=1,
    d_ff_expert=8192,
    shared_expert=True,
    capacity_factor=2.0,   # top-1 routing needs headroom (Switch-style)
)
