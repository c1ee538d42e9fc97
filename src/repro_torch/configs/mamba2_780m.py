"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]

d_inner = 2·1536 = 3072, head_dim 64 ⇒ 48 SSD heads, state 128. O(1) decode
state ⇒ runs long_500k. vocab padded 50280 -> 50288 for divisibility.
"""

from repro_torch.configs.base import ArchConfig

REAL_VOCAB = 50280

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                # attention-free, no separate MLP stack
    vocab=50288,           # padded from 50280
    act="gelu",
    norm="rmsnorm",
    pos_emb="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    conv_width=4,
)
