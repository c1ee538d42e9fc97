"""Elastic re-sharding: restore a checkpoint onto a *different* mesh (the
port of ``repro.distributed.elastic``).

Checkpoints hold full (unsharded) arrays (``training/checkpoint.py``), so
elasticity reduces to: load, build the new mesh's shardings from the same
logical axes, and place each array as a DTensor with its placements (each
device keeps its shard). Scale up, or go on after losing part of the mesh,
without touching the checkpoint format.

``reshard_tree`` is also the restart path after a failure: the supervisor
starts the launcher again with the surviving mesh and resumes from LATEST.
A train loop on one card resumes from the DTensors' local tensors
(``to_local()``), which hold the whole arrays there.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import make_rules, param_shardings


def _mesh_device(mesh) -> torch.device:
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def reshard_tree(tree: dict, specs: dict, cfg, mesh,
                 fsdp: bool = False) -> dict:
    """Place a flat ``{path: tensor}`` tree of full arrays onto ``mesh`` (a
    ``DeviceMesh``) per the logical axes of ``specs``: a DTensor per path,
    replicated where ``specs`` has no entry."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    rules = make_rules(cfg, mesh, fsdp=fsdp)
    shardings = param_shardings(specs, rules, mesh)
    dev = _mesh_device(mesh)
    out = {}
    for path, arr in tree.items():
        s = shardings.get(path)
        placements = s.placements if s is not None \
            else (Replicate(),) * mesh.ndim
        # every rank loaded the same arrays: each keeps its own shard, no
        # broadcast from a source rank
        out[path] = distribute_tensor(torch.as_tensor(arr).to(dev), mesh,
                                      placements, src_data_rank=None)
    return out


def elastic_restore(ckpt_dir: str, model, cfg, mesh, fsdp: bool = False):
    """``restore_latest`` and a reshard onto ``mesh``. Returns (step,
    params, state) or None without a checkpoint; the optimizer's moments
    mirror the parameters' shardings, its step counter stays a plain
    tensor on the mesh's device."""
    from repro_torch.training import checkpoint as ckpt

    resumed = ckpt.restore_latest(ckpt_dir)
    if resumed is None:
        return None
    step, tree = resumed
    specs = model.param_specs()
    params = reshard_tree(tree["params"], specs, cfg, mesh, fsdp=fsdp)
    state = tree["state"]
    state["opt"]["m"] = reshard_tree(state["opt"]["m"], specs, cfg, mesh,
                                     fsdp=fsdp)
    state["opt"]["v"] = reshard_tree(state["opt"]["v"], specs, cfg, mesh,
                                     fsdp=fsdp)
    state["opt"]["step"] = state["opt"]["step"].to(_mesh_device(mesh))
    return step, params, state
