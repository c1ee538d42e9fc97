"""internvl2-26b [vlm] — InternViT frontend (STUB) + InternLM2-20B backbone.
[arXiv:2404.16821; hf]

The assignment specifies the transformer BACKBONE only; the vision frontend is
a stub — ``input_specs()`` provides precomputed patch embeddings
(B, vision_tokens, 3200) which the model projects and prepends to the token
stream.

vocab is padded 92553 -> 92672 (multiple of 16·128) so the vocabulary axis
shards over the 16-way model axis; padded logit rows are never targeted.
"""

from repro_torch.configs.base import ArchConfig

REAL_VOCAB = 92553

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92672,           # padded from 92553 for model-axis divisibility
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    vision_tokens=1024,
    vision_feat_dim=3200,  # InternViT-6B hidden size
)
