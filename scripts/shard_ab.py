#!/usr/bin/env python3
"""Time the eager serving steps that the sharding annotations touch, in two
checkouts of the port on one card.

    python3 scripts/shard_ab.py --other DIR [--pairs 1]

``DIR`` is the root of another checkout (for example the parent commit,
unpacked with ``git archive``). The script runs ``--pairs`` pairs of
processes in turn, each pair in the other order than the last (other,
this, this, other, ...). Each process imports ``repro_torch`` from its
checkout, builds its attention libraries, and times on the host clock,
each call ended by ``torch.cuda.synchronize()``, the eager steps whose
per-call host work the model's ``shard`` calls add to (the CUDA graphs
replay none of it): llama3.2-1b in bf16 at full depth, a (1, 32) prefill
and a decode step (median of 50 after 5 warm calls), and hubert-xlarge's
(8, 781) encode (median of 5 after one). In a checkout that has the
sharding layer, each process also reads the host cost of the per-call work
that layer added (``host_cost``): how often one llama prefill and one
decode step call ``sharding.current_ctx`` (every ``shard`` and
``axis_ways`` call), ``_build.abstract`` and ``_build.ptr``, and each
call's host time, so that their product bounds what the added calls cost a
step. Prints one JSON line per process and a summary: each case's median
ms per checkout over its runs and the ratio this / other.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _median_ms(fn, warm: int, reps: int) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def host_cost(step) -> dict:
    """Calls of ``sharding.current_ctx``, ``_build.abstract`` and
    ``_build.ptr`` in one ``step()``, each one's host ns outside a context
    (mean of 200,000 calls on a CUDA tensor, the lambda's own call
    included) and their product in ms."""
    import timeit

    import torch

    from repro_torch.distributed import sharding
    from repro_torch.kernels import _build

    fns = {"current_ctx": sharding, "abstract": _build, "ptr": _build}
    calls = dict.fromkeys(fns, 0)
    saved = {name: getattr(mod, name) for name, mod in fns.items()}

    def counting(name, fn):
        def wrap(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrap

    for name, mod in fns.items():
        setattr(mod, name, counting(name, saved[name]))
    try:
        step()
        torch.cuda.synchronize()
    finally:
        for name, mod in fns.items():
            setattr(mod, name, saved[name])
    x, n = torch.empty(1, device="cuda"), 200_000
    ns = {"current_ctx": timeit.timeit(
              lambda: sharding.shard(x, ("batch", None)), number=n) / n * 1e9,
          "abstract": timeit.timeit(lambda: _build.abstract(x, x, x),
                                    number=n) / n * 1e9,
          "ptr": timeit.timeit(lambda: _build.ptr(x), number=n) / n * 1e9}
    return {"calls": calls, "ns": ns,
            "ms": sum(calls[k] * ns[k] for k in calls) / 1e6}


def child(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.modeling.registry import build_model

    if not str(Path(_build.__file__)).startswith(str(root)):
        raise SystemExit(f"imported {_build.__file__}, not from {root}")
    _build.build_all(("flash_attention", "decode_attention"))
    dev = torch.device("cuda", 0)
    out = {"checkout": str(root)}
    with torch.no_grad():
        model = build_model(get_config("llama3.2-1b"))
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev, cast=model.serving_cast)
        tokens = torch.randint(0, model.cfg.vocab, (1, 32), device=dev,
                               dtype=torch.int32)
        out["llama_prefill_ms"] = _median_ms(
            lambda: model.prefill(params, {"tokens": tokens}, 64), 5, 50)
        _, cache = model.prefill(params, {"tokens": tokens}, 64)
        token = tokens[:, -1].contiguous()
        out["llama_decode_ms"] = _median_ms(
            lambda: model.decode_step(params, cache, {"token": token}), 5, 50)
        if (root / "src/repro_torch/distributed/sharding.py").exists():
            out["host_cost"] = {
                "llama_prefill": host_cost(lambda: model.prefill(
                    params, {"tokens": tokens}, 64)),
                "llama_decode": host_cost(lambda: model.decode_step(
                    params, cache, {"token": token}))}
        del params, cache
        model = build_model(get_config("hubert-xlarge"))
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev, cast=model.serving_cast)
        frames = torch.randn(8, 781, model.cfg.frame_feat_dim, device=dev)
        out["hubert_encode_ms"] = _median_ms(
            lambda: model.encode(params, {"frames": frames}), 1, 5)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--other")
    p.add_argument("--pairs", type=int, default=1)
    p.add_argument("--child")
    args = p.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child).resolve())), flush=True)
        return 0
    if not args.other:
        p.error("pass --other DIR")
    roots = {"other": Path(args.other).resolve(), "this": ROOT}
    order = []
    for i in range(args.pairs):
        order += ["other", "this"] if i % 2 == 0 else ["this", "other"]
        order += order[-2:][::-1]
    runs: dict[str, list[dict]] = {"other": [], "this": []}
    for name in order:
        res = subprocess.run([sys.executable, __file__, "--child",
                              str(roots[name])], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": name, **row}), flush=True)
        runs[name].append(row)
    summary = {}
    for key in ("llama_prefill_ms", "llama_decode_ms", "hubert_encode_ms"):
        med = {n: statistics.median(r[key] for r in runs[n]) for n in runs}
        summary[key] = {**med, "this_over_other": med["this"] / med["other"]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
