"""Step construction for the dry run and the launchers (the port of
``repro.launch.steps``).

``build_cell`` assembles, for one (architecture x shape x mesh) cell:

- the step function (train / prefill / decode),
- its arguments as ``meta`` tensors (nothing allocated),
- a ``Sharding`` for every argument,

so the dry run can count the step (``launch/cost_analysis.py``) and a
launcher can ``materialize`` the arguments on a device at the global batch
it chooses and run the step under ``sharding_ctx(mesh, cell.rules)``.

Sharding policy:

- params and optimizer state by logical axes (``make_rules``); FSDP (the
  weights' d_model over the data axes) switches on above
  ``FSDP_PARAM_THRESHOLD`` parameters;
- batch over ("pod", "data"), falling back to a divisible prefix (long_500k
  has global_batch=1: replicated);
- caches by ``model.cache_axes()``: KV heads over "model" when divisible,
  otherwise the KV sequence over "model" (flash-decode sharding).

A serving cell's abstract parameters are all in ``cfg.dtype``, as the
reference's are; ``materialize`` gives them the serving cast instead (the
model's ``serving_cast``: norm scales and the MoE router kept in float32, as
the port's executors hold them).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.configs.specs import input_specs, meta
from repro_torch.distributed.sharding import (
    Sharding,
    axes_size,
    make_rules,
    mesh_sizes,
    param_shardings,
    spec_for,
)
from repro_torch.modeling.lm import torch_dtype
from repro_torch.modeling.registry import build_model
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step

# Above this many params, weights/optimizer shard over the data axes too.
FSDP_PARAM_THRESHOLD = 8_000_000_000


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str                      # train | prefill | decode
    step: Callable
    args: tuple                    # meta tensors
    in_shardings: tuple
    donate_argnums: tuple
    model: Any
    fsdp: bool
    rules: dict
    shape_cfg: ShapeConfig
    mesh: Any


def _batch_rule_for(B: int, mesh) -> tuple[str, ...] | None:
    """Largest prefix of ("pod", "data") whose product divides B."""
    sizes = mesh_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    # the full product first, then single axes (largest first)
    singles = sorted(axes, key=lambda a: -sizes[a])
    candidates = [tuple(axes)] + [(a,) for a in singles]
    for cand in candidates:
        size = axes_size(sizes, cand)
        if size > 1 and B % size == 0:
            return cand
    return None


def _tree_shardings(specs: dict, axes_map: Callable, rules, mesh) -> dict:
    return {k: Sharding(mesh, spec_for(axes_map(k, v), rules))
            for k, v in specs.items()}


def _batch_axes(_k, v):
    return ("batch",) + (None,) * (len(v.shape) - 1)


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               fsdp: bool | None = None) -> Cell:
    model = build_model(cfg)
    kind, specs = input_specs(cfg, shape)
    serving = kind != "train"
    if fsdp is None:
        fsdp = model.param_count() > FSDP_PARAM_THRESHOLD
        if serving and getattr(cfg, "serve_2d_ffn", False):
            fsdp = False  # 2D weight sharding replaces FSDP gathers
    rules = make_rules(cfg, mesh, fsdp=fsdp, serving=serving)
    rules = dict(rules, batch=_batch_rule_for(shape.global_batch, mesh))
    replicated = Sharding(mesh, ())
    pspecs = model.param_specs()
    psh = param_shardings(pspecs, rules, mesh)
    common = dict(model=model, fsdp=fsdp, rules=rules, shape_cfg=shape,
                  mesh=mesh)

    if kind == "train":
        params = model.abstract_params(torch_dtype(cfg.param_dtype))
        opt = {"opt": {
            "m": {k: meta(p.shape, torch.float32) for k, p in params.items()},
            "v": {k: meta(p.shape, torch.float32) for k, p in params.items()},
            "step": meta((), torch.int32),
        }}
        osh = {"opt": {"m": psh, "v": psh, "step": replicated}}
        batch = specs["batch"]
        bsh = _tree_shardings(batch, _batch_axes, rules, mesh)
        step = make_train_step(model, OptimizerConfig())
        return Cell(cfg.name, shape.name, kind, step, (params, opt, batch),
                    (psh, osh, bsh), donate_argnums=(0, 1), **common)

    params = model.abstract_params(torch_dtype(cfg.dtype))

    if kind == "prefill":
        batch = specs["batch"]
        bsh = _tree_shardings(batch, _batch_axes, rules, mesh)

        def prefill_step(params, batch):
            return model.prefill(params, batch)

        return Cell(cfg.name, shape.name, kind, prefill_step, (params, batch),
                    (psh, bsh), donate_argnums=(), **common)

    # ---- decode ------------------------------------------------------------
    cache = specs["cache"]
    batch = specs["batch"]
    cache_axes = model.cache_axes()
    csh = {k: Sharding(mesh, spec_for(cache_axes[k], rules)) for k in cache}
    bsh = _tree_shardings(batch, _batch_axes, rules, mesh)

    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return Cell(cfg.name, shape.name, kind, decode_step,
                (params, cache, batch), (psh, csh, bsh), donate_argnums=(1,),
                **common)


def _fill(name: str, like: torch.Tensor, cfg, seq_len: int, gen,
          device) -> torch.Tensor:
    """A data leaf of a cell's batch or cache, drawn from ``gen``."""
    shape, dt = tuple(like.shape), like.dtype
    if name in ("tokens", "targets", "token"):
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             device=device, dtype=torch.int32)
    if name == "loss_mask":
        return torch.ones(shape, dtype=dt, device=device)
    if name == "mask":  # the encoder's masked frames
        return torch.bernoulli(torch.full(shape, cfg.mask_prob, device=device),
                               generator=gen).to(dt)
    if name == "pos":  # a full cache: the step writes its last slot
        return torch.full(shape, seq_len - 1, dtype=dt, device=device)
    return torch.empty(shape, dtype=dt, device=device).normal_(generator=gen)


def materialize(cell: Cell, device=None, global_batch: int | None = None,
                seed: int = 0) -> tuple:
    """The cell's arguments as tensors on ``device`` (the card unless the
    caller asks for the CPU) at ``global_batch`` (default the cell's).
    Parameters come from ``model.init`` with a ``torch.Generator`` seeded
    with ``seed`` (float32 masters requiring a gradient for a train cell,
    with zero AdamW moments; the serving cast for a serving cell); the
    batch and the cache are drawn from a second generator seeded with
    ``seed + 1`` (token ids uniform over the vocabulary, loss masks of
    ones, cache values normal, ``pos`` at the cache's last slot)."""
    device = resolve_device(device)
    model, cfg = cell.model, cell.model.cfg
    shape = cell.shape_cfg
    if global_batch is not None:
        shape = replace(shape, global_batch=global_batch)
    _, specs = input_specs(cfg, shape)
    pgen = torch.Generator(device=device).manual_seed(seed)
    dgen = torch.Generator(device=device).manual_seed(seed + 1)
    if cell.kind == "train":
        params = model.init(pgen, device=device)
        for p in params.values():
            p.requires_grad_(True)
    else:
        params = model.init(pgen, device=device, cast=model.serving_cast)

    def fill(tree):
        return {k: _fill(k, v, cfg, shape.seq_len, dgen, device)
                for k, v in tree.items()}

    batch = fill(specs["batch"])
    if cell.kind == "train":
        return params, {"opt": init_opt_state(params)}, batch
    if cell.kind == "prefill":
        return params, batch
    return params, fill(specs["cache"]), batch
