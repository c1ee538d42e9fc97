"""hubert-xlarge [audio] — encoder-only transformer backbone. [arXiv:2106.07447]

The CNN waveform frontend is a STUB: input_specs provides precomputed frame
features (B, S, 512). Training is masked prediction over a 504-entry codebook
(vocab padded to 512 for model-axis divisibility). Encoder-only ⇒ the decode
shape cells are documented skips.
"""

from repro_torch.configs.base import ArchConfig

REAL_VOCAB = 504

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=512,             # padded from 504
    act="gelu",
    norm="layernorm",
    pos_emb="sinusoidal",  # conv-positional frontend stubbed
    frame_feat_dim=512,
    mask_prob=0.08,
)
