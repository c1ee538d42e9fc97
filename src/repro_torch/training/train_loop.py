"""Fault-tolerant training loop (the port of ``repro.training.train_loop``).

- **train step**: the loss and its gradients (``torch.autograd.grad`` of
  ``model.loss`` with respect to the flat parameter dict) → optional
  gradient compression with error feedback → global-norm clip → AdamW.
  ``microbatch`` > 1 accumulates the microbatches' gradients in float32 and
  averages them, and the losses and metrics, as the reference's scan does.
  On the card every attention forward of the step is K4 and every
  attention backward K4b (``FlashAttentionFn``), every RG-LRU scan K3 and
  K3b (``LinearScanFn``), every SSD K6 and K6b (``SSDScanFn``).
- **checkpoint/restart**: atomic keep-k checkpoints every N steps; on start
  the loop auto-resumes from LATEST (the data pipeline is counter-seeded
  and the optimizer state is saved).
- **failure injection**: ``FailureInjector`` raises at a given step;
  ``run_with_restarts`` restarts the loop from the last checkpoint.
- **straggler watchdog**: per-step wall-clock EWMA; steps slower than
  ``straggler_factor``× the EWMA are counted and logged.

A step reads one number back to the host, its loss (the reference's
``float(metrics["loss"])``), which also ends the step's work on the card
before its time is taken.

Initial parameters come from ``seed`` through a fresh ``torch.Generator``
on the device in every call, so two calls (or a restart that finds no
checkpoint) start from the same parameters, as the reference's immutable
``key`` does; the numbers are not ``jax.random``'s.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.distributed.compression import (
    CompressionConfig,
    compress_decompress,
    init_error_state,
)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import (
    OptimizerConfig,
    adamw_update,
    init_opt_state,
)


@dataclass
class LoopConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    keep: int = 3
    straggler_factor: float = 3.0
    compression: CompressionConfig = field(default_factory=CompressionConfig)


class SimulatedFailure(RuntimeError):
    pass


class FailureInjector:
    """Raises SimulatedFailure the first time ``step == fail_at``."""

    def __init__(self, fail_at: int | None):
        self.fail_at = fail_at
        self.fired = False

    def maybe_fail(self, step: int):
        if self.fail_at is not None and step == self.fail_at and not self.fired:
            self.fired = True
            raise SimulatedFailure(f"injected failure at step {step}")


def _value_and_grad(model, params: dict, batch: dict):
    keys = sorted(params)
    loss, metrics = model.loss(params, batch)
    # a parameter the loss does not read gets a zero gradient, as under
    # jax.grad (the encoder's mask_emb on a batch without a mask)
    grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                materialize_grads=True)
    return (loss.detach(), {k: m.detach() for k, m in metrics.items()}), \
        dict(zip(keys, grads))


def make_train_step(model, opt_cfg: OptimizerConfig,
                    comp_cfg: CompressionConfig | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` and the optimizer state are updated in place
    (``adamw_update``) and returned."""
    comp_cfg = comp_cfg or CompressionConfig()
    microbatch = getattr(model.cfg, "microbatch", 1)

    def grad_fn(params, batch):
        if microbatch <= 1:
            return _value_and_grad(model, params, batch)
        # gradient accumulation: k sequential microbatches cut live
        # activation memory ~k× at the same global batch (math unchanged)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        losses, metrics = [], []
        for i in range(microbatch):
            mb = {k: v.reshape(microbatch, v.shape[0] // microbatch,
                               *v.shape[1:])[i] for k, v in batch.items()}
            (loss, met), grads = _value_and_grad(model, params, mb)
            for k, g in grads.items():
                acc[k] += g.float()
            losses.append(loss)
            metrics.append(met)
        grads = {k: a / microbatch for k, a in acc.items()}
        metrics = {k: torch.mean(torch.stack([m[k] for m in metrics]))
                   for k in metrics[0]}
        return (torch.mean(torch.stack(losses)), metrics), grads

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = grad_fn(params, batch)
        new_state = dict(opt_state)
        if comp_cfg.scheme != "none":
            grads, new_state["err"] = compress_decompress(
                grads, opt_state["err"], comp_cfg,
                step=opt_state["opt"]["step"])
        params, new_state["opt"], opt_metrics = adamw_update(
            params, grads, opt_state["opt"], opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, new_state, metrics

    return train_step


def init_train_state(model, generator: torch.Generator, device=None,
                     comp_cfg: CompressionConfig | None = None):
    """(parameters drawn from ``generator`` on ``device``, each requiring a
    gradient; the optimizer state, with the error state under
    compression)."""
    params = model.init(generator, device=device)
    for p in params.values():
        p.requires_grad_(True)
    state = {"opt": init_opt_state(params)}
    if comp_cfg and comp_cfg.scheme != "none":
        state["err"] = init_error_state(params)
    return params, state


@dataclass
class TrainResult:
    losses: list
    final_step: int
    straggler_steps: int
    restarts: int = 0
    step_s: list = field(default_factory=list)  # host seconds per step


def _resume(tree: dict):
    params = {k: v.requires_grad_(True) if v.is_floating_point() else v
              for k, v in tree["params"].items()}
    state = tree["state"]
    # npz keeps scalars as 0-d arrays; the step counter is int32
    state["opt"]["step"] = state["opt"]["step"].to(torch.int32)
    return params, state


def train(model, pipeline, loop_cfg: LoopConfig, opt_cfg: OptimizerConfig,
          seed: int = 0, injector: FailureInjector | None = None,
          device=None, log: Callable | None = None) -> TrainResult:
    """Run (or resume) a training loop on ``device`` (the card unless the
    caller asks for the CPU). ``pipeline.batch(step)`` feeds data."""
    log = log or (lambda *a: None)
    device = resolve_device(device)
    step0 = 0
    comp = loop_cfg.compression

    resumed = None
    if loop_cfg.ckpt_dir:
        resumed = ckpt.restore_latest(loop_cfg.ckpt_dir, device)
    if resumed is not None:
        step0, tree = resumed
        params, state = _resume(tree)
        log(f"resumed from step {step0}")
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params, state = init_train_state(model, gen, device, comp)

    step_fn = make_train_step(model, opt_cfg, comp)

    losses, step_s, ewma, stragglers = [], [], None, 0
    step = step0
    while step < loop_cfg.steps:
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in pipeline.batch(step).items()}
        t0 = time.monotonic()
        params, state, metrics = step_fn(params, state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        if ewma is None:
            ewma = dt
        else:
            if dt > loop_cfg.straggler_factor * ewma:
                stragglers += 1
                log(f"straggler: step {step} took {dt:.3f}s (ewma {ewma:.3f}s)")
            ewma = 0.9 * ewma + 0.1 * dt
        losses.append(loss)
        step_s.append(dt)
        step += 1
        if step % loop_cfg.log_every == 0:
            log(f"step {step}: loss {loss:.4f} ({dt*1e3:.0f} ms)")
        if loop_cfg.ckpt_dir and step % loop_cfg.ckpt_every == 0:
            ckpt.save_checkpoint(loop_cfg.ckpt_dir, step,
                                 {"params": params, "state": state},
                                 keep=loop_cfg.keep)
        if injector:
            injector.maybe_fail(step)

    if loop_cfg.ckpt_dir:
        ckpt.save_checkpoint(loop_cfg.ckpt_dir, step,
                             {"params": params, "state": state}, keep=loop_cfg.keep)
    return TrainResult(losses=losses, final_step=step, straggler_steps=stragglers,
                       step_s=step_s)


def run_with_restarts(model, pipeline, loop_cfg: LoopConfig, opt_cfg: OptimizerConfig,
                      seed: int = 0, injector: FailureInjector | None = None,
                      max_restarts: int = 3, device=None,
                      log: Callable | None = None) -> TrainResult:
    """Supervisor: restart-from-checkpoint on (simulated) node failure."""
    restarts = 0
    while True:
        try:
            result = train(model, pipeline, loop_cfg, opt_cfg, seed=seed,
                           injector=injector, device=device, log=log)
            result.restarts = restarts
            return result
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            (log or (lambda *a: None))(f"restart #{restarts}")
