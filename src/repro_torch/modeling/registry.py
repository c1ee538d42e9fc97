"""Model registry: ArchConfig.family -> model class.

The decoder families (dense, MoE and VLM, all ``LM``), the SSM (Mamba-2)
and hybrid (Griffin) families are ported; the audio encoder raises until
its slice of the port (``ROADMAP.md``).
"""

from __future__ import annotations

from repro_torch.modeling.griffin import GriffinLM
from repro_torch.modeling.lm import LM
from repro_torch.modeling.mamba import MambaLM

FAMILIES = {"dense": LM, "moe": LM, "vlm": LM, "ssm": MambaLM,
            "hybrid": GriffinLM}
LATER = {"audio": "the audio-encoder slice"}


def build_model(cfg):
    cls = FAMILIES.get(cfg.family)
    if cls is not None:
        return cls(cfg)
    if cfg.family in LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; it "
            f"comes with {LATER[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r} for arch {cfg.name!r}")
