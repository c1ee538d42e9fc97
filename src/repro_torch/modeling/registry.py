"""Model registry: ArchConfig.family -> model class.

The dense, SSM (Mamba-2) and hybrid (Griffin) families are ported; the
others raise until their slice of the port (``ROADMAP.md``): the MoE and
VLM families and the audio encoder.
"""

from __future__ import annotations

from repro_torch.modeling.griffin import GriffinLM
from repro_torch.modeling.lm import LM
from repro_torch.modeling.mamba import MambaLM

FAMILIES = {"dense": LM, "ssm": MambaLM, "hybrid": GriffinLM}
LATER = {
    "moe": "the MoE/VLM slice",
    "vlm": "the MoE/VLM slice",
    "audio": "the audio-encoder slice",
}


def build_model(cfg):
    cls = FAMILIES.get(cfg.family)
    if cls is not None:
        return cls(cfg)
    if cfg.family in LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; it "
            f"comes with {LATER[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r} for arch {cfg.name!r}")
