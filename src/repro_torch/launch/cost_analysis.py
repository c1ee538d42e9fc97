"""Cost analysis of a cell (the port's counterpart of
``repro.launch.hlo_analysis``).

The reference compiles each cell and reads its numbers from the compiled
program: FLOPs and HBM bytes from the post-optimization HLO text (with
while-loop trip counts), memory from XLA's ``memory_analysis``, collective
bytes from the HLO's collectives. The port compiles nothing and emits no
HLO, so the text parser has no subject. ``analyze_cell(cell)`` counts what
the port can count, under ``analyze_compiled``'s output keys:

- ``hlo.flops``: the step traced once over fake tensors
  (``FakeTensorMode``): ``FlopCounterMode`` counts its matrix products
  outside the kernels (``dot_flops``; the layers run in a Python loop, so
  no trip count is missed; a train step includes the backward pass, the
  remat's recompute and AdamW), and ``kernels.counting`` adds each model
  kernel's own work (``kernel_flops``, by kernel: ``kernels/flops.py``, the
  work the bounds of ``chip_smoke.py`` count), so no plain scan is stepped
  over fake tensors. These are the whole step's FLOPs, over all devices:
  how GSPMD would split (or replicate) the work per device is not modeled.
- ``hlo.collective_link_bytes``: per device, the bytes one step's parameter
  and gradient collectives put on the links, by the ring formulas of the
  reference (all-gather (g-1) x operand, reduce-scatter (g-1)/g x operand,
  all-reduce 2 (g-1)/g x operand): a train step's gradient all-reduce over
  the data axes that do not shard the parameter and, under FSDP, each
  weight's all-gather (in the forward and again in the backward) and its
  gradient's reduce-scatter; a serving step under FSDP gathers each weight
  once. Activation collectives (the model-parallel layers' all-reduces,
  the MoE all-to-alls) are not counted.
- ``memory``: per device, the bytes of the parameters, the optimizer
  state, the cache and the batch, exact from the shardings
  (``argument_bytes``; ``alias_bytes``: those of the donated arguments),
  and ``peak_bytes_estimate``, an estimate: the arguments, plus a train
  step's gradients as the parameters are sharded, plus what
  ``MemTracker`` (``torch.distributed._tools.mem_tracker``) sees the step
  allocate beyond its arguments and full-size gradients over fake tensors
  at the per-device batch, with the weights unsharded.

HBM bytes and element-wise FLOPs are not counted.
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import replace

import torch

from repro_torch import kernels
from repro_torch.configs.specs import input_specs
from repro_torch.distributed.sharding import axes_size, mesh_sizes

PEAK_METHOD = ("per-device arguments (exact) + train gradients sharded as "
               "their parameters + MemTracker's peak over a FakeTensorMode "
               "step at the per-device batch less that step's arguments and "
               "full-size gradients (weights unsharded there)")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    elif isinstance(tree, tuple):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def _zip_leaves(tree, shard_tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _zip_leaves(tree[k], shard_tree[k])
    else:
        yield tree, shard_tree


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def _local_bytes(t, sharding) -> int:
    return _nbytes(sharding.local_shape(tuple(t.shape)), t.dtype)


def _cell_args(cell, global_batch):
    """The cell's meta arguments, at ``global_batch`` when given."""
    if global_batch is None or global_batch == cell.shape_cfg.global_batch:
        return cell.args
    _, specs = input_specs(cell.model.cfg,
                           replace(cell.shape_cfg, global_batch=global_batch))
    if cell.kind == "decode":
        return cell.args[0], specs["cache"], specs["batch"]
    return cell.args[:-1] + (specs["batch"],)


def _fake_args(mode, args, train: bool):
    """Fake CPU tensors of the meta ``args`` (no memory), the parameters
    requiring a gradient in a train cell."""
    def conv(t):
        with mode:
            return torch.empty(t.shape, dtype=t.dtype, device="cpu")

    def walk(tree):
        return {k: walk(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else conv(tree)

    out = tuple(walk(a) for a in args)
    if train:
        for p in out[0].values():
            p.requires_grad_(True)
    return out


@contextlib.contextmanager
def _no_fake_in_caches():
    """Keep fake tensors out of the model's per-device caches (the RoPE
    frequencies, the sinusoidal position tables): a table made during a
    fake run is a fake tensor, which a later real run on the same device
    would read. The RoPE cache is restored as it was; the position tables'
    cache is emptied (they are made again on first use)."""
    from repro_torch.modeling import layers

    saved = dict(layers._FREQS)
    try:
        yield
    finally:
        layers._FREQS.clear()
        layers._FREQS.update(saved)
        layers.sinusoidal_positions.cache_clear()


def count_flops(cell, global_batch: int | None = None) -> dict:
    """The step's FLOPs over fake tensors: ``dot_flops`` (FlopCounterMode,
    outside the kernels), ``kernel_flops`` and ``kernel_calls`` by kernel,
    and their sum ``flops``; ``kernel_dense_flops``, what FlopCounterMode
    would count over the kernels' plain versions instead."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    args = _fake_args(mode, _cell_args(cell, global_batch),
                      cell.kind == "train")
    counter = FlopCounterMode(display=False)
    with _no_fake_in_caches(), mode, counter, kernels.counting() as kc:
        cell.step(*args)
    dot = float(counter.get_total_flops())
    kflops = {k: v["flops"] for k, v in sorted(kc.items())}
    return {"dot_flops": dot, "kernel_flops": kflops,
            "kernel_calls": {k: v["calls"] for k, v in sorted(kc.items())},
            "kernel_dense_flops": {k: v["dense_flops"]
                                   for k, v in sorted(kc.items())},
            "flops": dot + sum(kflops.values())}


def _step_allocations(cell, local_batch: int) -> float:
    """MemTracker's peak over the fake step at ``local_batch``, less the
    step's arguments and (train) its full-size gradients."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    args = _fake_args(mode, _cell_args(cell, local_batch),
                      cell.kind == "train")
    arg_bytes = sum(_nbytes(t.shape, t.dtype) for t in _leaves(args))
    grads = sum(_nbytes(p.shape, torch.float32) for p in args[0].values()) \
        if cell.kind == "train" else 0
    tracker = MemTracker()
    with _no_fake_in_caches(), mode:
        tracker.track_external(*_leaves(args))
        with tracker, kernels.counting():
            cell.step(*args)
    peak = sum(dev_stats.get("Total", 0) for dev_stats in
               tracker.get_tracker_snapshot("peak").values())
    return max(0.0, float(peak) - arg_bytes - grads)


def memory(cell, global_batch: int | None = None) -> dict:
    """Per-device bytes of the cell's arguments (at ``global_batch`` when
    given), exact from the shardings, and the peak estimate (see the module
    docstring)."""
    names = {"train": ("params", "opt", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "cache", "batch")}[cell.kind]
    batch = global_batch or cell.shape_cfg.global_batch
    out = {}
    for name, arg, sh in zip(names, _cell_args(cell, batch),
                             cell.in_shardings):
        out[f"{name}_bytes"] = sum(_local_bytes(t, s)
                                   for t, s in _zip_leaves(arg, sh))
    out["argument_bytes"] = sum(out[f"{n}_bytes"] for n in names)
    out["alias_bytes"] = sum(out[f"{names[i]}_bytes"]
                             for i in cell.donate_argnums)
    grads = 0
    if cell.kind == "train":
        grads = sum(_nbytes(s.local_shape(tuple(p.shape)), torch.float32)
                    for p, s in zip(cell.args[0].values(),
                                    cell.in_shardings[0].values()))
    out["grad_bytes"] = grads
    local_batch = max(batch // axes_size(mesh_sizes(cell.mesh),
                                       cell.rules.get("batch")), 1)
    out["step_alloc_bytes"] = _step_allocations(cell, local_batch)
    out["peak_bytes_estimate"] = (out["argument_bytes"] + grads
                                  + out["step_alloc_bytes"])
    out["peak_method"] = PEAK_METHOD
    return out


def collectives(cell) -> dict:
    """Per-device link bytes of one step's parameter and gradient
    collectives, by kind (see the module docstring)."""
    sizes = mesh_sizes(cell.mesh)
    data_axes = tuple(cell.rules.get("batch") or ())
    fsdp_axes = tuple(cell.rules.get("embed_fsdp") or ()) if cell.fsdp \
        else ()
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    params, psh = cell.args[0], cell.in_shardings[0]
    for path, p in params.items():
        spec_axes = {a for e in psh[path].spec if e is not None
                     for a in ((e,) if isinstance(e, str) else e)}
        local = _local_bytes(p, psh[path])
        gathered = tuple(a for a in fsdp_axes if a in spec_axes)
        g = axes_size(sizes, gathered)
        if g > 1:  # the weight's all-gather over its FSDP axes
            out["all-gather"] += (g - 1) * local * (
                2 if cell.kind == "train" else 1)
        if cell.kind != "train":
            continue
        grad_local = _nbytes(psh[path].local_shape(tuple(p.shape)),
                             torch.float32)
        if g > 1:  # reduce-scatter of the g-shard gradient: (g-1)/g x g x local
            out["reduce-scatter"] += (g - 1) * grad_local
        rest = axes_size(sizes, (a for a in data_axes
                                 if a not in spec_axes))
        if rest > 1:  # data-parallel all-reduce over the other data axes
            out["all-reduce"] += 2.0 * (rest - 1) / rest * grad_local
    return {"collective_link_bytes": sum(out.values()),
            "collectives": {k: v for k, v in out.items() if v}}


def analyze_cell(cell, global_batch: int | None = None) -> dict:
    """The cell's cost analysis (per-device numbers but ``hlo.flops``, the
    whole step's): ``{"hlo": {...}, "memory": {...}}``, at another global
    batch than the cell's when ``global_batch`` is given (the shardings
    stay the cell's)."""
    hlo = count_flops(cell, global_batch)
    hlo.update(collectives(cell))
    return {"hlo": hlo, "memory": memory(cell, global_batch)}


def save_json(path: str, obj: dict):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
