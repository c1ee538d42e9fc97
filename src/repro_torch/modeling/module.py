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
...) are mapped to mesh axes by ``repro_torch.distributed.sharding``
(``param_axes``); ``abstract_params`` gives the parameters as tensors on the
``meta`` device, for the launch layer's cells and dry run, allocating
nothing.
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


# elements of a parameter drawn at a time (256 MB in float32): a large
# parameter is drawn in slices along its first axis, each rounded to its
# serving dtype as soon as it is drawn
DRAW_ELEMS = 1 << 26


def _fill(piece, spec: ParamSpec, scale: float, generator) -> torch.Tensor:
    if spec.init == "embed":
        return piece.normal_(0.0, 1.0, generator=generator).mul_(scale)
    torch.nn.init.trunc_normal_(piece, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    return piece.mul_(scale)


def init_param(generator: torch.Generator, spec: ParamSpec,
               dtype=torch.float32, device=None,
               out_dtype=None) -> torch.Tensor:
    """One parameter drawn in ``dtype`` and returned in ``out_dtype``
    (default ``dtype``). It is drawn in slices of whole rows of its first
    axis, at most ``DRAW_ELEMS`` elements each (one slice for all but the
    largest parameters), in order, each rounded into the result as soon as
    it is drawn: no ``dtype`` copy of a large parameter is made (a
    256,000 x 4,096 embedding would be 4.2 GB in float32). The slices
    depend on the shape alone, so the values do not depend on
    ``out_dtype``: a bf16 result is the float32 one rounded."""
    out_dtype = out_dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=out_dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=out_dtype, device=device)
    if spec.init == "embed":
        scale = spec.scale if spec.scale is not None else 1.0
    else:  # truncated-normal fan-in init for projections
        scale = spec.scale if spec.scale is not None \
            else 1.0 / np.sqrt(_fan_in(spec.shape))
    scale = float(scale)
    out = torch.empty(spec.shape, dtype=out_dtype, device=device)
    rows = max(1, DRAW_ELEMS // int(np.prod(spec.shape[1:])))
    for i in range(0, spec.shape[0], rows):
        j = min(i + rows, spec.shape[0])
        out[i:j].copy_(_fill(torch.empty((j - i, *spec.shape[1:]),
                                         dtype=dtype, device=device),
                             spec, scale, generator))
    return out


def init_params(generator: torch.Generator, specs: dict[str, ParamSpec],
                dtype=torch.float32, device=None,
                cast=None) -> dict[str, torch.Tensor]:
    """Every parameter of ``specs``, drawn in sorted-path order from
    ``generator`` (which must live on ``device``). ``cast(path, tensor)``,
    when given, says the dtype each parameter is kept in: the parameter is
    drawn in ``dtype`` slice by slice and rounded to that dtype as it is
    drawn (``init_param``), so a caller that keeps lower-precision copies
    never holds a whole float32 master of one, let alone of all."""
    probe = torch.empty((), dtype=dtype)
    return {path: init_param(generator, spec, dtype, device,
                             None if cast is None else cast(path, probe).dtype)
            for path, spec in sorted(specs.items())}


def abstract_params(specs: dict[str, ParamSpec],
                    dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Every parameter as a ``meta`` tensor of its shape in ``dtype``: no
    memory is allocated."""
    return {p: torch.empty(s.shape, dtype=dtype, device="meta")
            for p, s in specs.items()}


def param_axes(specs: dict[str, ParamSpec]) -> dict[str, tuple[str | None, ...]]:
    return {p: s.axes for p, s in specs.items()}


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


def layer_slices(stacked_params: dict) -> list[dict]:
    """Every layer's params of a stacked subtree at once, for a training
    pass: one ``unbind`` per stacked tensor, whose backward writes the
    layers' gradients into one stacked gradient. (Indexing one layer at a
    time, ``layer_slice``, would make each layer's gradient a full-size
    zero tensor with its slice filled, and add those: for llama3.2-1b 16
    fills and 15 adds of 3.9 GB per step.)"""
    parts = {k: v.unbind(0) for k, v in stacked_params.items()}
    n = len(next(iter(parts.values()))) if parts else 0
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]
