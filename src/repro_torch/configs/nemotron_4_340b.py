"""nemotron-4-340b [dense] — GQA (kv=8), squared-ReLU MLP. [arXiv:2402.16819]

At 340B dense this is the arch that REQUIRES FSDP weight sharding over the
data axis on a 256-chip pod (bf16 params alone are 42 GB/chip under pure
16-way tensor parallelism).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    act="sqrelu",          # squared ReLU, non-gated
    norm="layernorm",
    rope_theta=10000.0,
)
