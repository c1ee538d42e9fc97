"""AdamW and the LR schedule, written out as formulas (the port of
``repro.training.optimizer``).

Not ``torch.optim.AdamW``: the reference adds ``eps`` to ``sqrt(vhat)``
after the bias correction and puts the weight decay inside the update
(``delta = mhat / (sqrt(vhat) + eps) + wd * p``), clipping by the global
norm first; each value here is rounded as that formula rounds it, in
float32. Trees are flat dicts ``{path: tensor}`` walked in sorted-path
order, the order in which ``jax.tree`` walks the reference's dicts.

The reference returns new arrays; ``adamw_update`` writes the new
parameters and moments into the given tensors instead (for llama3.2-1b,
18 GB of the card not allocated a second time) and returns those dicts.
The step counter and the learning rate stay on the parameters' device, so
an update reads nothing back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_schedule(cfg: OptimizerConfig, step):
    """Linear warmup then cosine decay to min_lr_frac·peak, in float32;
    ``step`` an int or a tensor (whose device the result takes)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params: dict) -> dict:
    """Zero moments beside every parameter (its shape, dtype and device)
    and a 0-d int32 step counter."""
    device = next(iter(params.values())).device if params else None
    return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in sorted-path order, of each leaf's
    float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict,
                 cfg: OptimizerConfig):
    """One AdamW step. Returns (params, state, {"lr", "grad_norm"}), the
    parameters and moments updated in place (see the module docstring)."""
    step = state["step"] + 1
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** sf, 1 - b2 ** sf
    for k in sorted(params):
        p, m, v = params[k], state["m"][k], state["v"][k]
        g = grads[k].float()
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
