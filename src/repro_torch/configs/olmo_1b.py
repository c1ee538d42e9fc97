"""olmo-1b [dense] — non-parametric LayerNorm. [arXiv:2402.00838; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,         # MHA
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    act="swiglu",
    norm="np_layernorm",   # OLMo: no learned scale/bias
    rope_theta=10000.0,
)
