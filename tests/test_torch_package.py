"""Package rules of the port (``repro_torch``).

- nothing under ``src/repro_torch/`` and nothing in ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``repro`` (an AST scan of every import);
- ``import repro_torch`` (and every module of the slice) works without
  triton and without CUDA, and imports neither triton nor jax;
- entry points raise without CUDA unless the caller passes ``device="cpu"``;
- a CPU tensor runs a kernel's plain version and leaves every launch
  counter at 0.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import kernels, resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = sorted(m for m in _imported_modules(path)
                 if m.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.name} imports {bad}"


def test_import_needs_no_triton_and_no_cuda():
    code = (
        "import sys, torch\n"
        "import repro_torch, repro_torch.kernels\n"
        "import repro_torch.core.torch_core, repro_torch.core.runtime\n"
        "import repro_torch.core.convert\n"
        "import repro_torch.kernels.gbrt_predict.ops\n"
        "import repro_torch.kernels.linear_scan.ops\n"
        "import repro_torch.kernels.state_replay.ref\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('triton', 'jax', 'repro')]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._LIBS\n"
        "print('ok')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": "",
           "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.core.decision import DecisionEngine, MinLatencyPolicy
    from repro_torch.core.fit import build_fleet_predictor, fit_app
    from repro_torch.core.runtime import PlacementRuntime, TwinBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    _, models = fit_app("IR", seed=0, n_inputs=40, configs=(1536,))
    pred = build_fleet_predictor(models, 1, configs=(1536,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecisionEngine(predictor=pred, policy=MinLatencyPolicy(c_max=1e-5))
    eng = DecisionEngine(predictor=pred, policy=MinLatencyPolicy(c_max=1e-5),
                         device="cpu")
    twin, _ = fit_app("IR", seed=0, n_inputs=40, configs=(1536,))
    rt = PlacementRuntime(eng, TwinBackend(twin, seed=0,
                                           edge_names=pred.edge_names))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.serve_stream(twin.workload(8), array_backend="torch",
                        device="cuda")
    assert repro_torch.DTYPE == torch.float64


def test_cpu_tensors_launch_no_kernel(rng):
    from repro_torch.core.gbrt import GBRT, GBRTConfig
    from repro_torch.kernels.gbrt_predict.ops import (
        gbrt_predict,
        gbrt_predict_configs,
    )
    from repro_torch.kernels.linear_scan.ops import linear_scan, prefix_sum
    from repro_torch.kernels.state_replay.kernel import (
        state_replay,
        state_walk,
    )

    kernels.reset_launch_counts()
    x = rng.normal(size=(64, 2))
    m = GBRT.fit(x, x[:, 0] * 3.0, GBRTConfig(n_trees=5, max_depth=2))
    gbrt_predict(m, torch.as_tensor(x))
    gbrt_predict_configs([m], torch.ones(1, dtype=torch.float64),
                         torch.as_tensor(x[:, 0]))
    linear_scan(torch.ones((1, 4, 2)), torch.ones((1, 4, 2)))
    prefix_sum(torch.ones(5, dtype=torch.float64))
    state_replay(torch.zeros(4, dtype=torch.float64),
                 torch.zeros(4, dtype=torch.int32),
                 ecomp=torch.ones((4, 1), dtype=torch.float64),
                 h0=torch.zeros(1, dtype=torch.float64), lpw=True,
                 edge_col=0)
    state_walk(torch.zeros(4, dtype=torch.float64), 4,
               ecomp=torch.ones((4, 1), dtype=torch.float64),
               elat=torch.ones((4, 1), dtype=torch.float64),
               h0=torch.zeros(1, dtype=torch.float64), lpw=True,
               minlat=False, deadline=1.0)
    counts = kernels.launch_counts()
    assert set(counts) == {"gbrt_predict_multi", "gbrt_predict_blocked",
                           "linear_scan", "state_replay", "state_walk"}
    assert set(counts.values()) == {0}
    assert np.isfinite(gbrt_predict(m, torch.as_tensor(x)).numpy()).all()
