"""Architecture + shape configuration for the assigned model pool."""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # "dense" | "moe" | "vlm" | "hybrid" | "audio" | "ssm"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"            # "swiglu" | "geglu" | "sqrelu" | "gelu"
    norm: str = "rmsnorm"          # "rmsnorm" | "layernorm" | "np_layernorm"
    rope_theta: float = 10000.0
    pos_emb: str = "rope"          # "rope" | "sinusoidal" | "none"
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    shared_expert: bool = False
    # --- hybrid (Griffin / RG-LRU) ---
    attn_window: int = 0           # 0 = global attention; >0 = local window
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    d_rnn: int = 0
    conv_width: int = 4
    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # --- VLM ---
    vision_tokens: int = 0
    vision_feat_dim: int = 0
    # --- audio (encoder-only) ---
    frame_feat_dim: int = 0
    mask_prob: float = 0.08        # masked-prediction training (HuBERT)
    # --- runtime knobs (perf-relevant; §Perf iterates on these) ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    q_chunk: int = 512             # query chunking for flash-style attention
    loss_chunk: int = 1024         # sequence chunking for the softmax-xent loss
    moe_group: int = 256           # sequence group size for MoE dispatch
    capacity_factor: float = 1.25
    remat: str = "full"            # "none" | "dots" | "full"
    logits_softcap: float = 0.0
    tie_embeddings: bool = False
    scan_layers: bool = True
    attn_impl: str = "xla"         # "xla" | "pallas" (pallas targets real TPUs)
    # --- §Perf hillclimb knobs (defaults = paper-faithful baseline) ---
    loss_impl: str = "onehot"      # "onehot" | "gather" target-logit lookup
    banded_window: bool = False    # local attention: banded K/V slices (O(S·W))
    cp_attn: bool = False          # context parallelism: shard q-seq over model
    sp_acts: bool = False          # Megatron-style sequence-sharded residuals
    microbatch: int = 1            # grad-accumulation microbatches per step
    rglru_block_gates: int = 0     # 0=dense gates; N=block-diagonal (Griffin §2.4)
    serve_2d_ffn: bool = False     # serving: FFN/expert weights 2D-sharded
                                   # (model×data) — no per-step weight gathers
    moe_batch_groups: bool = False # decode: one capacity pool across the batch
    kv_quant: bool = False         # int8 KV cache (per-slot-head scales)

    # ------------------------------------------------------------- helpers
    @property
    def is_encoder_only(self) -> bool:
        return self.family == "audio"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM state or local window.)"""
        return self.family in ("ssm", "hybrid")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def with_updates(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape × step-kind) cell of the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned shape suites (LM shapes are seq_len × global_batch).
TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def applicable_shapes(cfg: ArchConfig) -> dict[str, ShapeConfig | None]:
    """The 4 assigned cells for an arch; None = documented skip (DESIGN.md §6).

    - ``long_500k`` needs sub-quadratic attention → only SSM/hybrid run it;
    - encoder-only archs have no decode step → decode cells skipped.
    """
    cells: dict[str, ShapeConfig | None] = {}
    for name, s in SHAPES.items():
        if s.kind == "decode" and cfg.is_encoder_only:
            cells[name] = None
        elif name == "long_500k" and not cfg.sub_quadratic:
            cells[name] = None
        else:
            cells[name] = s
    return cells
