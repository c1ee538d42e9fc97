"""olmoe-1b-7b [moe] — 64 experts top-8, expert d_ff=1024. [arXiv:2409.02060; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    n_experts=64,
    top_k=8,
    d_ff_expert=1024,
    capacity_factor=1.25,
)
