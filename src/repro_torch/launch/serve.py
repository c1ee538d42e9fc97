"""Serving launcher: the paper's dynamic task placement over live executors.

The port of ``repro.launch.serve``, with the same flags plus ``--device``.
Calibrates per-slice performance models against REAL executions (paper
Sec. IV-C), then serves a Poisson LLM request stream through the Decision
Engine (paper Alg. 1 / min-cost) against the live executor pool — the
Table-V live-prototype analog. Like the reference it serves the arch's
smoke-size reduction (``configs.smoke_config``).

Example (on the CUDA card; ``--device cpu`` runs it on the CPU;
``--arch mamba2-780m`` serves the Mamba-2 LM, ``--arch recurrentgemma-9b``
the Griffin hybrid and ``--arch olmoe-1b-7b`` the MoE decoder instead of
llama3.2-1b):
    PYTHONPATH=src python -m repro_torch.launch.serve --policy minlat \
        --n 120 --rate 20 --cmax 0.004 --alpha 0.02
"""

from __future__ import annotations

import argparse

from repro_torch.configs import smoke_config
from repro_torch.core.decision import HedgedPolicy, MinCostPolicy, MinLatencyPolicy
from repro_torch.serving.executors import SliceSpec
from repro_torch.serving.placement import (
    calibrate_catalog,
    llm_workload,
    make_live_runtime,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--policy", choices=("minlat", "mincost"), default="minlat")
    p.add_argument("--n", type=int, default=120)
    p.add_argument("--rate", type=float, default=20.0, help="requests/s")
    p.add_argument("--mean-tokens", type=float, default=256.0)
    p.add_argument("--cmax", type=float, default=0.004, help="$ per task")
    p.add_argument("--alpha", type=float, default=0.02)
    p.add_argument("--deadline-ms", type=float, default=400.0)
    p.add_argument("--quantile", type=float, default=None,
                   help="beyond-paper: predict this latency quantile (e.g. 0.95)")
    p.add_argument("--hedge-ms", type=float, default=None,
                   help="beyond-paper: hedged dispatch threshold")
    p.add_argument("--t-idl-s", type=float, default=60.0)
    p.add_argument("--chips", type=int, nargs="+", default=[2, 4, 8])
    p.add_argument("--calib-tasks", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    cfg = smoke_config(args.arch)
    specs = [SliceSpec(f"slice{c}", c) for c in args.chips]
    print(f"calibrating {len(specs)} slice configs on {cfg.name} "
          f"(real cold starts and executions)...")
    cat = calibrate_catalog(cfg, specs, n_tasks=args.calib_tasks, seed=args.seed,
                            device=args.device)
    print(f"  cold start: {cat.start_cold.mean:.0f}±{cat.start_cold.std:.0f} ms; "
          f"warm: {cat.start_warm.mean:.2f} ms")

    if args.policy == "minlat":
        policy = MinLatencyPolicy(c_max=args.cmax, alpha=args.alpha)
        if args.hedge_ms is not None:
            policy = HedgedPolicy(policy, hedge_threshold_ms=args.hedge_ms)
    else:
        policy = MinCostPolicy(deadline_ms=args.deadline_ms)

    tasks = llm_workload(args.n, rate_per_s=args.rate, seed=args.seed + 1,
                         mean_tokens=args.mean_tokens)
    runtime = make_live_runtime(cat, policy, t_idl_ms=args.t_idl_s * 1e3,
                                quantile=args.quantile, device=args.device)
    res = runtime.serve(tasks)

    print(f"\nserved n={res.n}")
    print(f"  avg actual latency   : {res.avg_actual_latency_ms:.1f} ms "
          f"(p95 {res.p95_actual_latency_ms:.1f}, p99 {res.p99_actual_latency_ms:.1f})")
    print(f"  latency pred error   : {res.latency_error_pct:.2f} %")
    print(f"  total actual cost    : ${res.total_actual_cost:.6f} "
          f"(pred err {res.cost_error_pct:.2f} %)")
    if args.policy == "minlat":
        print(f"  budget used          : {res.pct_budget_used:.1f} % "
              f"(violations {res.pct_cost_violated:.2f} %)")
    else:
        print(f"  deadline violations  : {res.pct_deadline_violated:.2f} % "
              f"(avg {res.avg_violation_ms:.1f} ms)")
    print(f"  warm/cold mismatches : {res.n_warm_cold_mismatches}/{res.n}")
    print(f"  edge executions      : {res.n_edge}/{res.n}")
    by = {}
    for r in res.records:
        by[r.target] = by.get(r.target, 0) + 1
    print(f"  placement histogram  : {dict(sorted(by.items()))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
