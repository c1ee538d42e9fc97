"""Gradient compression with error feedback (the port of
``repro.distributed.compression``).

Two schemes, both with error feedback, so what compression drops is carried
into the next step instead of being lost:

- ``topk``: keep the top-k fraction of entries by magnitude per tensor
  (``torch.topk``);
- ``int8``: per-tensor scale and stochastic rounding; the noise of tensor
  ``i`` at step ``s`` comes from a ``torch.Generator`` seeded from
  ``(seed, s * 10_000 + i)``, so a run is reproducible (its numbers are not
  ``jax.random``'s).

``compress_decompress`` is the simulation the train step runs: grad ->
compress -> decompress, plus the new error state. ``compressed_bytes``
counts the bytes a step would move under the scheme. Trees are flat dicts
walked in sorted-path order, as ``jax.tree`` walks the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"  # "none" | "topk" | "int8"
    topk_frac: float = 0.05
    seed: int = 0


def init_error_state(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _topk_cd(g, frac: float):
    """Top-|g| sparsification: the dense decompressed tensor."""
    flat = g.reshape(-1)
    k = max(int(math.ceil(flat.shape[0] * frac)), 1)
    idx = torch.topk(torch.abs(flat), k).indices
    mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
    return (flat * mask).reshape(g.shape)


def _generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from the pair (seed, stream)."""
    mixed = np.random.SeedSequence([seed, stream]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) << 32 | int(mixed[1]))


def _int8_cd(g, generator):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    scaled = g / scale
    noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def compress_decompress(grads: dict, error_state: dict,
                        cfg: CompressionConfig, step=0):
    """Error-feedback compression: returns (decompressed grads, new error
    state)."""
    if cfg.scheme == "none":
        return grads, error_state
    step = int(step)
    out_g, out_e = {}, {}
    for i, k in enumerate(sorted(grads)):
        g = grads[k]
        corrected = g.float() + error_state[k]
        if cfg.scheme == "topk":
            d = _topk_cd(corrected, cfg.topk_frac)
        elif cfg.scheme == "int8":
            d = _int8_cd(corrected, _generator(cfg.seed, step * 10_000 + i,
                                               g.device))
        else:
            raise ValueError(f"unknown compression scheme {cfg.scheme!r}")
        out_g[k] = d.to(g.dtype)
        out_e[k] = corrected - d
    return out_g, out_e


def compressed_bytes(params: dict, cfg: CompressionConfig) -> int:
    """Bytes that would cross the data-parallel link per step."""
    n = sum(int(np.prod(tuple(p.shape))) for p in params.values())
    if cfg.scheme == "none":
        return n * 4
    if cfg.scheme == "topk":
        k = int(np.ceil(n * cfg.topk_frac))
        return k * (4 + 4)  # value + index
    if cfg.scheme == "int8":
        return n * 1 + 4
    raise ValueError(cfg.scheme)
