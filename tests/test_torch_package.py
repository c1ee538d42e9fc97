"""Package rules of the port (``repro_torch``).

- nothing under ``src/repro_torch/``, nothing in ``chip_smoke.py`` and no
  ``examples/*_torch.py`` imports ``jax`` or the JAX package ``repro`` (an
  AST scan of every import);
- ``import repro_torch`` (and every module of the slice) works without
  triton and without CUDA, and imports neither triton nor jax;
- entry points (placement, model steps, executors, pools, calibration, the
  live runtime, the serve CLI, the planner, its runtime factory and the
  deprecated ``Simulation``) raise without CUDA unless the caller passes
  ``device="cpu"``;
- a CPU tensor runs a kernel's plain version and leaves every launch
  counter at 0;
- ``kernels.recording`` tallies the launches of the calling thread alone,
  and those counted for its block on another thread (K4b's, on autograd's
  device thread; a ``carry_recording`` function's), and the launch
  counters lose no count under concurrent threads;
- each CUDA source's nvcc flags (``-fmad=false`` on all but
  ``flash_attention``) and the library hash over them and over the headers
  a source includes.
"""

from __future__ import annotations

import ast
import subprocess
import sys
import threading
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
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


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
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.kernels.ssd_scan.ops\n"
        "import repro_torch.configs, repro_torch.modeling.lm\n"
        "import repro_torch.modeling.mamba, repro_torch.modeling.ssd\n"
        "import repro_torch.modeling.registry, repro_torch.modeling.convert\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.core, repro_torch.core.multiapp\n"
        "import repro_torch.core.simulator, repro_torch.trace\n"
        "import repro_torch.planner\n"
        "import repro_torch.modeling.losses, repro_torch.launch.train\n"
        "import repro_torch.training.train_loop\n"
        "import repro_torch.distributed.compression\n"
        "import repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.elastic, repro_torch.configs.specs\n"
        "import repro_torch.launch.mesh, repro_torch.launch.steps\n"
        "import repro_torch.launch.cost_analysis, repro_torch.launch.dryrun\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
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


@pytest.mark.parametrize("name", ["gbrt_predict", "linear_scan",
                                  "state_replay", "flash_attention",
                                  "flash_attention_bwd", "decode_attention",
                                  "ssd_scan"])
def test_nvcc_flags_per_source(name, monkeypatch):
    """Every source keeps -fmad=false (its parity with the plain version
    rests on no contracted multiply-add) except the attention kernels,
    whose softmax and dot products want their FMAs; the library's hash
    covers the flags, so a changed flag rebuilds."""
    from repro_torch.kernels import _build

    fmad = ("flash_attention", "flash_attention_bwd", "decode_attention")
    assert name in _build.SOURCES
    flags = _build.flags(name)
    assert ("-fmad=false" in flags) == (name not in fmad)
    assert "arch=compute_90a,code=sm_90a" in flags
    before = _build.lib_path(name)
    monkeypatch.setattr(_build, "FMAD_SOURCES", () if name in fmad
                        else (name,))
    assert _build.flags(name) != flags
    assert _build.lib_path(name) != before


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


def test_planner_and_simulation_raise_without_cuda(monkeypatch):
    """The planner, its runtime factory and the deprecated ``Simulation``
    (through the engine it is given) default to the card and raise without
    one; ``device="cpu"`` is the only way onto the CPU."""
    from repro_torch.core.decision import DecisionEngine, MinLatencyPolicy
    from repro_torch.core.fit import build_fleet_predictor, fit_app
    from repro_torch.core.simulator import Simulation
    from repro_torch.planner import (
        SLO,
        Candidate,
        Planner,
        TwinRuntimeFactory,
        plan,
    )
    from repro_torch.trace import Trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = Trace.from_arrays([0.0, 5.0], [1e5, 2e5], [1e3, 1e3],
                              app_names=("IR",))
    cand = Candidate.make("c", 1, cloud_configs=(1536,))
    slo = SLO(latency_ms=1e4)
    twin, models = fit_app("IR", seed=0, n_inputs=40, configs=(1536,))
    for call in (lambda: Planner(trace, slo),
                 lambda: plan(trace, [cand], slo, fit_configs=(1536,)),
                 lambda: TwinRuntimeFactory(app="IR", candidate=cand),
                 lambda: Simulation(twin, DecisionEngine(
                     predictor=build_fleet_predictor(models, 1,
                                                     configs=(1536,)),
                     policy=MinLatencyPolicy(c_max=1e-5)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    factory = TwinRuntimeFactory(app="IR", candidate=cand, n_inputs=40,
                                 fit_configs=(1536,), device="cpu")
    assert factory().engine.device == torch.device("cpu")
    res = plan(trace, [cand], slo, n_inputs=40, fit_configs=(1536,),
               device="cpu", parallel=False)
    assert res.best.n == 2
    eng = DecisionEngine(predictor=build_fleet_predictor(models, 1,
                                                         configs=(1536,)),
                         policy=MinLatencyPolicy(c_max=1e-5), device="cpu")
    with pytest.warns(DeprecationWarning):
        sim = Simulation(twin, eng)
    assert sim.engine.device == torch.device("cpu")


def test_serving_entry_points_raise_without_cuda(monkeypatch):
    """The model and serving entry points default to the card and raise
    without one; ``device="cpu"`` is the only way onto the CPU."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.decision import MinLatencyPolicy
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving import (
        LivePlacementServer,
        SliceSpec,
        calibrate_catalog,
        make_compiled_steps,
        make_live_runtime,
        make_pool,
    )
    from repro_torch.serving.executors import LiveExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("llama3.2-1b").with_updates(
        n_layers=1, d_model=16, d_ff=32, vocab=32, n_heads=2, n_kv_heads=1,
        head_dim=8)
    spec = SliceSpec("s2", 2)
    policy = MinLatencyPolicy(c_max=0.01)
    for call in (lambda: make_compiled_steps(cfg),
                 lambda: LiveExecutor(spec, cfg),
                 lambda: make_pool(cfg, [spec]),
                 lambda: calibrate_catalog(cfg, [spec], n_tasks=2, n_cold=1),
                 lambda: serve_cli.main(["--n", "2", "--chips", "2",
                                         "--calib-tasks", "2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cat = calibrate_catalog(cfg, [spec], n_tasks=2, n_cold=1, device="cpu")
    for call in (lambda: make_live_runtime(cat, policy),
                 lambda: LivePlacementServer(cat, policy)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    rt = make_live_runtime(cat, policy, device="cpu")
    assert rt.engine.device == torch.device("cpu")
    assert all(ex.device == torch.device("cpu")
               for ex in rt.backend.pool.edges.values())


def test_cpu_tensors_launch_no_kernel(rng):
    from repro_torch.core.gbrt import GBRT, GBRTConfig
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_bhd,
    )
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_bwd_bhsd,
    )
    from repro_torch.kernels.gbrt_predict.ops import (
        gbrt_predict,
        gbrt_predict_configs,
    )
    from repro_torch.kernels.linear_scan.kernel import linear_scan_bwd_bsd
    from repro_torch.kernels.linear_scan.ops import linear_scan, prefix_sum
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd_bhsd
    from repro_torch.kernels.ssd_scan.ops import ssd
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
    q = torch.ones((1, 2, 4, 8))
    flash_attention_bhsd(q, q[:, :1], q[:, :1])
    flash_attention_bwd_bhsd(q, q[:, :1], q[:, :1], q, q)
    decode_attention_bhd(q[:, :, :1], q[:, :1], q[:, :1],
                         torch.tensor([3], dtype=torch.int32))
    ssd(torch.ones((1, 6, 2, 4)), torch.ones((1, 6, 2)), -torch.ones(2),
        torch.ones((1, 6, 3)), torch.ones((1, 6, 3)), chunk=4)
    s = torch.ones((1, 4, 2))
    linear_scan_bwd_bsd(s, s[:, 0], s, s)
    xs = torch.ones((1, 2, 6, 4))
    ssd_scan_bwd_bhsd(xs, torch.ones((1, 2, 6)), -torch.ones(2),
                      torch.ones((1, 6, 3)), torch.ones((1, 6, 3)), xs,
                      chunk=4)
    counts = kernels.launch_counts()
    assert set(counts) == {"gbrt_predict_multi", "gbrt_predict_blocked",
                           "linear_scan", "linear_scan_bwd", "state_replay",
                           "state_walk", "flash_attention",
                           "flash_attention_bwd", "decode_attention",
                           "ssd_scan", "ssd_scan_bwd"}
    assert set(counts.values()) == {0}
    assert np.isfinite(gbrt_predict(m, torch.as_tensor(x)).numpy()).all()


def test_recording_sees_only_its_own_thread():
    """A wrapper's count takes every thread's launches; a ``recording``
    block tallies those of its own thread, as a graph capture in one
    executor needs while another executor's thread launches kernels. Blocks
    nest: an inner block's launches count in the block around it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_bhd,
    )
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd

    kernels.reset_launch_counts()
    inside, done = threading.Event(), threading.Event()

    def other_thread():
        inside.wait()
        for _ in range(3):
            _build.counted(flash_attention_bhsd)
        done.set()

    t = threading.Thread(target=other_thread)
    t.start()
    with kernels.recording() as tally:
        inside.set()
        done.wait()
        _build.counted(decode_attention_bhd)
        with kernels.recording() as inner:  # blocks nest
            _build.counted(decode_attention_bhd)
            _build.counted(flash_attention_bhsd)
        assert inner == {"decode_attention": 1, "flash_attention": 1}
    t.join()
    assert tally == {"decode_attention": 2, "flash_attention": 1}
    counts = kernels.launch_counts()
    assert counts["decode_attention"] == 2 and counts["flash_attention"] == 4
    _build.counted(decode_attention_bhd)  # outside the block: not tallied
    assert tally == {"decode_attention": 2, "flash_attention": 1}
    kernels.reset_launch_counts()


def _on_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()


def test_recording_counts_a_launch_made_for_it_on_another_thread():
    """A launch counted on another thread with the tally a block had open
    (as autograd's device thread counts K4b with the tally that
    ``FlashAttentionFn``'s forward kept) shows in that block and in the
    blocks around it; nested blocks still merge. Once the block has closed,
    such a launch counts only in the wrapper's ``launches``, never in a
    block around it or in a later block."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_bwd_bhsd,
    )

    def backward(tally, n=1):
        _on_thread(lambda: [_build.counted(flash_attention_bwd_bhsd, tally)
                            for _ in range(n)])

    kernels.reset_launch_counts()
    assert _build.current_tally() is None
    with kernels.recording() as outer:
        _build.counted(flash_attention_bhsd)
        with kernels.recording() as inner:
            captured = _build.current_tally()
            _build.counted(flash_attention_bhsd)
            backward(captured, 2)
        assert inner == {"flash_attention": 1, "flash_attention_bwd": 2}
        backward(captured)  # the inner block has closed: global count only
        around = _build.current_tally()
        backward(around)
    assert outer == {"flash_attention": 2, "flash_attention_bwd": 3}
    backward(around)
    with kernels.recording() as later:
        backward(captured)
    assert later == {}
    assert outer == {"flash_attention": 2, "flash_attention_bwd": 3}
    assert kernels.launch_counts()["flash_attention_bwd"] == 6
    assert _build.current_tally() is None
    kernels.reset_launch_counts()


def test_carry_recording_runs_a_function_in_the_callers_block():
    """``carry_recording`` binds a function to the block open where it was
    made: run on another thread (as autograd runs a checkpointed layer's
    recompute), its launches show in that block, and that thread's own
    tally is restored after; made outside any block it is the function
    itself."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd

    def launch():
        _build.counted(flash_attention_bhsd)
        return _build.current_tally()

    assert kernels.carry_recording(launch) is launch
    kernels.reset_launch_counts()
    seen = []
    with kernels.recording() as tally:
        carried = kernels.carry_recording(launch)
        _on_thread(lambda: seen.extend([carried(), _build.current_tally()]))
        carried()
    assert tally == {"flash_attention": 2}
    assert seen[0] is not None and seen[1] is None
    assert kernels.launch_counts()["flash_attention"] == 2
    kernels.reset_launch_counts()


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """K4, K4b and K6b include the shared ``fa_mma.cuh``: each library's
    name hashes it with the source, so an edited header rebuilds those three
    and no other."""
    import shutil

    from repro_torch.kernels import _build

    users = {"flash_attention", "flash_attention_bwd", "ssd_scan_bwd"}
    for name in users:
        assert _build.CSRC / "fa_mma.cuh" in _build.sources(name)
    for path in _build.CSRC.iterdir():
        if path.is_file():
            shutil.copy(path, tmp_path / path.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build.lib_path(name) for name in _build.SOURCES}
    header = tmp_path / "fa_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    changed = {name for name in _build.SOURCES
               if _build.lib_path(name) != before[name]}
    assert changed == users


def test_launch_counts_survive_concurrent_threads():
    """``counted`` takes a lock: 8 threads x 10,000 calls on one wrapper
    add up to exactly 80,000 (sharded runtimes launch from many threads).
    The dummy's ``launches`` is a Python property, so its read and its
    write are separate frames a thread switch can fall between (without the
    lock this loses most of the counts)."""
    from repro_torch.kernels import _build

    class Counter:
        n = 0

        @property
        def launches(self):
            return self.n

        @launches.setter
        def launches(self, value):
            self.n = value

    dummy = Counter()

    start = threading.Barrier(8)

    def hammer():
        start.wait()
        for _ in range(10_000):
            _build.counted(dummy)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert dummy.launches == 80_000


def test_launch_counts_change_only_where_kernels_launch():
    """A wrapper's ``launches`` is set to 0 or raised by one in
    ``_build.counted``, nowhere else in the port (no code credits or takes
    back launches it did not make), and each wrapper calls ``counted``."""
    counted = set()
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.AugAssign) and \
                    getattr(node.target, "attr", None) == "launches":
                assert path.name == "_build.py", f"{path}:{node.lineno}"
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if getattr(t, "attr", None) == "launches":
                        assert isinstance(node.value, ast.Constant) and \
                            node.value.value == 0, f"{path}:{node.lineno}"
            elif isinstance(node, ast.Call) and \
                    getattr(node.func, "attr", None) == "counted":
                counted.add(node.args[0].id)
    assert counted == {fn.__name__ for fn in kernels.wrappers().values()}
