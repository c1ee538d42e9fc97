"""Dry run of the production distribution config, without hardware (the port
of ``repro.launch.dryrun``).

For every (architecture x shape x mesh) cell it builds the cell on a
production mesh (``make_production_mesh``: 256 or 512 devices on PyTorch's
fake process group, so run it in its own process) with ``meta`` arguments,
and records ``cost_analysis.analyze_cell``: the step's FLOPs traced over
fake tensors, the per-device bytes of its arguments, a peak estimate and
the parameter and gradient collectives. Nothing is allocated at the cells'
size and no kernel runs.

    python -m repro_torch.launch.dryrun --list --all
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --mesh pod

One JSON file per cell goes to ``--out-dir`` (``build/dryrun``), in the
reference's row layout; the reference's ``lower_s``/``compile_s`` become
``build_s`` (the cell) and ``analyze_s`` (its analysis).
"""

from __future__ import annotations

import argparse
import os
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config
from repro_torch.launch.cost_analysis import analyze_cell, save_json
from repro_torch.launch.mesh import destroy_group, make_production_mesh
from repro_torch.launch.steps import build_cell

OUT_DIR_DEFAULT = "build/dryrun"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = OUT_DIR_DEFAULT, overrides: dict | None = None,
             tag: str = "") -> dict:
    """Build and analyse one cell on the production mesh; dump the
    analysis."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_updates(**overrides)
    shape = SHAPES[shape_name]
    mesh_name = "multipod" if multi_pod else "pod"
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = build_cell(cfg, shape, mesh)
    t_build = time.time() - t0
    analysis = analyze_cell(cell)
    t_analyze = time.time() - t0 - t_build

    result = {
        "arch": arch, "shape": shape_name, "kind": cell.kind,
        "mesh": mesh_name, "devices": int(mesh.size()), "fsdp": cell.fsdp,
        "param_count": cell.model.param_count(),
        "active_param_count": cell.model.active_param_count(),
        "build_s": round(t_build, 2), "analyze_s": round(t_analyze, 2),
    }
    result.update(analysis)
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}_{shape_name}_{mesh_name}{tag}.json"
    save_json(os.path.join(out_dir, fname), result)
    return result


def _fmt(result: dict) -> str:
    mem = result.get("memory", {})
    peak = mem.get("peak_bytes_estimate", 0) / 2**30
    args = mem.get("argument_bytes", 0) / 2**30
    coll = result.get("hlo", {}).get("collective_link_bytes", 0) / 2**30
    fl = result.get("hlo", {}).get("flops", 0) / 1e12
    return (f"{result['arch']:>26s} {result['shape']:<12s} "
            f"{result['mesh']:<8s} {result['kind']:<7s} "
            f"args/dev={args:7.2f} GiB  peak/dev~{peak:7.2f} GiB  "
            f"flops/step={fl:11.3f} T  coll/dev={coll:7.3f} GiB  "
            f"analyze={result['analyze_s']:6.1f}s")


def iter_cells(archs=None, shapes=None):
    for arch in (archs or sorted(ARCHS)):
        cells = applicable_shapes(get_config(arch))
        for sname, s in cells.items():
            if shapes and sname not in shapes:
                continue
            yield arch, sname, s is None  # (arch, shape, skipped)


def _skip_reason(arch: str) -> str:
    return ("encoder-only" if get_config(arch).is_encoder_only
            else "needs sub-quadratic attention")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", action="append", help="architecture id(s)")
    p.add_argument("--shape", action="append", choices=sorted(SHAPES),
                   help="shape cell(s)")
    p.add_argument("--mesh", choices=("pod", "multipod", "both"),
                   default="both")
    p.add_argument("--all", action="store_true", help="all 40 cells")
    p.add_argument("--out-dir", default=OUT_DIR_DEFAULT)
    p.add_argument("--list", action="store_true", help="list cells and exit")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="ArchConfig override for variants, e.g. "
                        "--set sp_acts=true --set microbatch=4")
    p.add_argument("--tag", default="", help="suffix for variant JSON files")
    args = p.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                overrides[k] = v

    archs = args.arch or (sorted(ARCHS) if args.all else None)
    if archs is None:
        p.error("pass --arch <id> (repeatable) or --all")
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    if args.list:
        for arch, sname, skipped in iter_cells(archs, args.shape):
            print(f"{arch:>26s} {sname:<12s} "
                  f"{'SKIP (documented)' if skipped else 'run'}")
        return 0

    failures, n_run, n_skip = [], 0, 0
    try:
        for arch, sname, skipped in iter_cells(archs, args.shape):
            if skipped:
                n_skip += 1
                print(f"{arch:>26s} {sname:<12s} SKIP (documented: "
                      f"{_skip_reason(arch)})")
                continue
            for mp in meshes:
                try:
                    res = run_cell(arch, sname, multi_pod=mp,
                                   out_dir=args.out_dir,
                                   overrides=overrides or None, tag=args.tag)
                    print(_fmt(res), flush=True)
                    n_run += 1
                except Exception:
                    failures.append((arch, sname,
                                     "multipod" if mp else "pod"))
                    print(f"{arch:>26s} {sname:<12s} "
                          f"{'multipod' if mp else 'pod':<8s} "
                          f"FAILED:\n{traceback.format_exc()}", flush=True)
    finally:
        destroy_group()

    print(f"\ndry-run: {n_run} analysed, {n_skip} documented skips, "
          f"{len(failures)} failures")
    for f in failures:
        print(f"  FAILED: {f}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
