"""Checkpointing: atomic, keep-k, auto-resume (the port of
``repro.training.checkpoint``, with the same on-disk layout, so a
checkpoint written by either package restores in the other).

Layout::

    <dir>/step_000123/arrays.npz     # flat {escaped_path: np.ndarray}
    <dir>/step_000123/META.json      # step, keys, dtypes
    <dir>/LATEST                     # text pointer, written last (commit point)

Writes go to a temp directory then ``os.rename`` (atomic on POSIX) — a crash
mid-save can never corrupt the latest checkpoint, which is what checkpoint/
restart fault tolerance rests on. Tensors are written as numpy arrays (from
whatever device holds them) and come back as tensors on the caller's
``device``.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

_SEP = "|"  # npz keys cannot contain '/' reliably across tools


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(directory: str, step: int, state: dict, keep: int = 3) -> str:
    """Atomically save ``state`` (pytree of arrays) as step ``step``."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    final = os.path.join(directory, name)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten(state)
    arrays = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v) for k, v in flat.items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "n_arrays": len(arrays)}
    with open(os.path.join(tmp, "META.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    # commit point: LATEST names the new checkpoint
    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.rename(latest_tmp, os.path.join(directory, "LATEST"))

    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int):
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    pointer = os.path.join(directory, "LATEST")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    if not os.path.exists(path):
        return None
    return int(name.split("_")[1])


def restore_checkpoint(directory: str, step: int, device=None) -> dict:
    """The saved tree, every array a tensor on ``device`` (default: the
    CPU) with its saved dtype and shape."""
    path = os.path.join(directory, f"step_{step:09d}", "arrays.npz")
    with np.load(path) as z:
        flat = {k: torch.as_tensor(z[k], device=device) for k in z.files}
    return _unflatten(flat)


def restore_latest(directory: str, device=None) -> tuple[int, dict] | None:
    step = latest_step(directory)
    if step is None:
        return None
    return step, restore_checkpoint(directory, step, device)
