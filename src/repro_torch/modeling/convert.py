"""Parameters across packages: the JAX package's flat LM param dict, as
numpy arrays, becomes the port's parameter dict, so that both packages
compute the same model (the tests carry the JAX params over this way). It
goes through ``build_model(cfg).param_specs()``, so it covers every family
the port has: the decoder ``LM`` (dense, MoE with its ``moe/`` and
``shared_mlp/`` parameters and the grouped ``layers_dense/`` and
``layers_moe/`` stacks, VLM with ``vision_proj/w``), the SSM family's
``MambaLM``, the hybrid family's ``GriffinLM`` (its stacked
``rec_layers/`` and ``attn_layers/`` parameters carry over by name) and
the audio family's ``AudioEncoder`` (``frontend/w``, ``frontend/b``, the
top-level ``mask_emb``, the stacked ``layers/``, ``ln_f`` and
``head/w``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.modeling.registry import build_model


def lm_params_from_numpy(cfg, arrays: dict, device=None,
                         dtype=torch.float32) -> dict[str, torch.Tensor]:
    """``{path: np.ndarray}`` (the JAX ``model.init`` dict, each array
    through ``np.asarray``) -> ``{path: torch.Tensor}`` on ``device`` in
    ``dtype``. Paths and shapes must be exactly those of the port's
    ``param_specs`` for ``cfg``."""
    specs = build_model(cfg).param_specs()
    missing = sorted(set(specs) - set(arrays))
    extra = sorted(set(arrays) - set(specs))
    if missing or extra:
        raise KeyError(f"param paths differ: missing {missing}, extra {extra}")
    out = {}
    for path, spec in specs.items():
        a = np.asarray(arrays[path])
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {a.shape} != {spec.shape}")
        out[path] = torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                                 device=device)
    return out
