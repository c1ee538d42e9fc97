"""Model registry: ArchConfig.family -> model class.

Every family of the reference is ported: the decoder families (dense, MoE
and VLM, all ``LM``), the SSM (Mamba-2) and hybrid (Griffin) families and
the audio encoder (HuBERT).
"""

from __future__ import annotations

from repro_torch.modeling.encoder import AudioEncoder
from repro_torch.modeling.griffin import GriffinLM
from repro_torch.modeling.lm import LM
from repro_torch.modeling.mamba import MambaLM

FAMILIES = {"dense": LM, "moe": LM, "vlm": LM, "ssm": MambaLM,
            "hybrid": GriffinLM, "audio": AudioEncoder}


def build_model(cfg):
    cls = FAMILIES.get(cfg.family)
    if cls is None:
        raise ValueError(f"unknown family {cfg.family!r} for arch "
                         f"{cfg.name!r}")
    return cls(cfg)
