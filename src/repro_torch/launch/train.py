"""Training launcher of the port: the fault-tolerant loop on one card (the
CPU only when asked for with ``--device cpu``). The same CLI as
``repro.launch.train``, plus ``--device``. Features exercised here:

- checkpoint/restart (atomic keep-k, auto-resume from LATEST),
- failure injection + supervisor restart (--fail-at),
- gradient compression (--compression topk|int8),
- straggler watchdog (per-step EWMA, logged),
- deterministic counter-seeded data (resumable from a step index).

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --device cpu --steps 60 --ckpt-dir ckpt --fail-at 25
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
        --layers 4 --batch 2 --seq 2048 --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
        --batch 8 --seq 781 --steps 10

(``--arch hubert-xlarge`` trains the audio encoder by masked prediction on
the synthetic frame batches of ``training.data.AudioPipeline``; ``--seq``
counts frames: 781 is a 250,000-sample crop at 16 kHz through the 320x
frontend.)
"""

from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed.compression import CompressionConfig
from repro_torch.modeling.registry import build_model
from repro_torch.training.data import make_pipeline
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import (
    FailureInjector,
    LoopConfig,
    run_with_restarts,
    train,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config (CPU-sized)")
    p.add_argument("--width", type=int, default=0,
                   help="override d_model (0 = config default)")
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--fail-at", type=int, default=None,
                   help="inject a failure at this step (tests restart)")
    p.add_argument("--compression", choices=("none", "topk", "int8"),
                   default="none")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    updates = {}
    if args.width:
        updates["d_model"] = args.width
    if args.layers:
        updates["n_layers"] = args.layers
    if updates:
        cfg = cfg.with_updates(**updates)

    model = build_model(cfg)
    print(f"arch={cfg.name} family={cfg.family} params={model.param_count():,} "
          f"device={device}")

    pipeline = make_pipeline(cfg, seq_len=args.seq, global_batch=args.batch,
                             seed=args.seed)
    loop_cfg = LoopConfig(
        steps=args.steps, log_every=max(args.steps // 10, 1),
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        compression=CompressionConfig(scheme=args.compression),
    )
    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                              decay_steps=args.steps)

    injector = FailureInjector(args.fail_at) if args.fail_at else None
    runner = run_with_restarts if injector else train
    result = runner(model, pipeline, loop_cfg, opt_cfg, seed=args.seed,
                    injector=injector, device=device, log=print)
    print(f"done: step={result.final_step} loss[first→last]="
          f"{result.losses[0]:.4f}→{result.losses[-1]:.4f} "
          f"stragglers={result.straggler_steps} restarts={result.restarts}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
