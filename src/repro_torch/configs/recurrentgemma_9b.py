"""recurrentgemma-9b [hybrid] — Griffin: RG-LRU + local attention 1:2,
window 2048, MQA. [arXiv:2402.19427]

38 layers with pattern (rec, rec, attn): 12 full groups + (rec, rec) tail =
26 recurrent + 12 local-attention layers. Sub-quadratic ⇒ runs long_500k.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,          # MQA local attention
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    act="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    attn_window=2048,
    block_pattern=("rec", "rec", "attn"),
    d_rnn=4096,
    conv_width=4,
)
