"""Train a ~100M-parameter llama-family model with the PyTorch port's
production loop (checkpointing, auto-resume, straggler watchdog): the
counterpart of ``examples/train_100m.py``, on the CUDA card by default.

A mid-run failure is injected to demonstrate checkpoint/restart fault
tolerance: the supervisor restarts from the last checkpoint and the loss
curve continues where it left off.

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_100m_torch.py --device cpu
"""

import argparse
import tempfile

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.modeling.registry import build_model
from repro_torch.training.data import make_pipeline
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import (
    FailureInjector,
    LoopConfig,
    run_with_restarts,
)

p = argparse.ArgumentParser()
p.add_argument("--steps", type=int, default=200)
p.add_argument("--batch", type=int, default=8)
p.add_argument("--seq", type=int, default=256)
p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
args = p.parse_args()
device = resolve_device(args.device)

# ~100M params: llama3.2-1b narrowed (d_model 768, 12 layers, vocab 32k)
cfg = get_config("llama3.2-1b").with_updates(
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
    d_ff=2048, vocab=32000, dtype="float32", remat="none",
    q_chunk=128, loss_chunk=128, scan_layers=True)
model = build_model(cfg)
print(f"model: {model.param_count()/1e6:.1f}M params "
      f"({cfg.n_layers}L d={cfg.d_model}) on {device}")

pipeline = make_pipeline(cfg, seq_len=args.seq, global_batch=args.batch, seed=0)

with tempfile.TemporaryDirectory() as ckpt_dir:
    loop = LoopConfig(steps=args.steps, log_every=max(args.steps // 10, 1),
                      ckpt_every=25, ckpt_dir=ckpt_dir, keep=2)
    opt = OptimizerConfig(peak_lr=3e-4, warmup_steps=20, decay_steps=args.steps)
    injector = FailureInjector(fail_at=args.steps // 2)
    print(f"training {args.steps} steps; a node failure is injected at step "
          f"{args.steps // 2} (expect restart + resume)...")
    res = run_with_restarts(model, pipeline, loop, opt, seed=0,
                            injector=injector, device=device, log=print)
    print(f"\nfinal: step {res.final_step}, "
          f"loss {res.losses[0]:.3f} → {res.losses[-1]:.3f}, "
          f"restarts {res.restarts}, stragglers {res.straggler_steps}")
    assert res.losses[-1] < res.losses[0], "loss should decrease"
