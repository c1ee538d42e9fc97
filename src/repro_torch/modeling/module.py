"""Minimal functional parameter substrate, the port of ``repro.modeling.module``.

Params live in a flat dict ``{path: torch.Tensor}``. Each model declares its
parameters once through ``param_specs() -> {path: ParamSpec}``, the single
source of truth for initialization, the parameter count and the converter
that carries the JAX package's params across (``modeling/convert.py``).

``init_params`` draws every parameter from one explicit ``torch.Generator``
in sorted-path order: truncated normal on [-2, 2] times a fan-in scale for
projections, a scaled normal for embeddings, zeros and ones as named. The
numbers differ from ``jax.random``'s for the same seed; tests that compare
the two packages carry the JAX params across instead.

The logical axis names of each spec (``"embed"``, ``"heads"``, ``"mlp"``,
...) are kept from the reference for the later sharded slices; on one card
they are documentation only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # "normal" | "zeros" | "ones" | "embed"
    scale: float | None = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(shape: tuple[int, ...]) -> int:
    # For projection kernels (..., out) all but the last dim are fan-in.
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return int(np.prod(shape[:-1]))


def init_param(generator: torch.Generator, spec: ParamSpec,
               dtype=torch.float32, device=None) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    if spec.init == "embed":
        scale = spec.scale if spec.scale is not None else 1.0
        return out.normal_(0.0, 1.0, generator=generator).mul_(scale)
    # truncated-normal fan-in init for projections
    scale = spec.scale if spec.scale is not None \
        else 1.0 / np.sqrt(_fan_in(spec.shape))
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.mul_(float(scale))


def init_params(generator: torch.Generator, specs: dict[str, ParamSpec],
                dtype=torch.float32, device=None,
                cast=None) -> dict[str, torch.Tensor]:
    """Every parameter of ``specs``, drawn in sorted-path order from
    ``generator`` (which must live on ``device``). ``cast(path, tensor)``,
    when given, is applied to each parameter as soon as it is drawn, so a
    caller that keeps lower-precision copies never holds all the float32
    masters at once."""
    out = {}
    for path, spec in sorted(specs.items()):
        t = init_param(generator, spec, dtype, device)
        out[path] = cast(path, t) if cast is not None else t
    return out


def param_count(specs: dict[str, ParamSpec]) -> int:
    return int(sum(np.prod(s.shape) for s in specs.values()))


def stacked(spec: ParamSpec, n_layers: int) -> ParamSpec:
    """Stack a per-layer spec along a leading layer axis."""
    return ParamSpec(shape=(n_layers, *spec.shape), axes=("layers", *spec.axes),
                     init=spec.init, scale=spec.scale)


def prefix_specs(prefix: str, specs: dict[str, ParamSpec]) -> dict[str, ParamSpec]:
    return {f"{prefix}/{k}": v for k, v in specs.items()}


def subtree(params: dict, prefix: str) -> dict:
    """View of a flat param dict under ``prefix`` (keys relativized)."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in params.items() if k.startswith(p)}


def layer_slice(stacked_params: dict, i: int) -> dict:
    """Layer ``i`` of a stacked param subtree (views, no copies)."""
    return {k: v[i] for k, v in stacked_params.items()}
