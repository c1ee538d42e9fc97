"""The port's launch layer (``repro_torch.launch``: cells, the dry run and its
cost analysis; ``distributed/elastic.py``) held against the JAX package's.

- ``_batch_rule_for`` gives the reference's values;
- ``build_cell`` for llama3.2-1b's three shapes on the host mesh matches
  the reference's: argument leaves (shape and dtype, key for key), specs,
  ``donate_argnums``, ``fsdp`` and rules, with nothing allocated; a
  smoke-size train cell materialized on the CPU takes the step that
  ``make_train_step`` takes on the same arguments, bit for bit;
- ``elastic_restore`` after 4 steps returns step 4, the checkpoint's values
  and placements from ``spec_for``;
- the dry run's FLOPs: ``kernels.counting`` plus ``FlopCounterMode`` over
  fake tensors equal ``FlopCounterMode`` over the plain path at smoke size
  (within 1e-9 relative) for a dense, an SSM, a hybrid, an MoE and a VLM
  config, each cell kind, and the audio encoder's train and prefill cells
  (each materialized on the CPU and stepped); the kernels' work formulas
  agree with explicit counts;
  the counting branch never takes a tensor with data;
- the dry run's listing equals the reference's, and a production cell is
  analysed on the fake process group without allocating.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import configs as jcfgs
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro_torch import configs as tcfgs
from repro_torch import kernels
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import Sharding, sharding_ctx, spec_for
from repro_torch.kernels import flops
from repro_torch.launch import cost_analysis, dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import destroy_group, make_host_mesh

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


@pytest.fixture
def host_mesh():
    """The CPU host mesh on a one-process group, torn down after the
    test."""
    try:
        yield make_host_mesh("cpu")
    finally:
        destroy_group()


def test_batch_rule_fallback():
    for B in (256, 16, 1, 32, 2):
        assert tsteps._batch_rule_for(B, FakeMesh()) == \
            jsteps._batch_rule_for(B, FakeMesh())
    assert tsteps._batch_rule_for(256, FakeMesh()) == ("pod", "data")
    assert tsteps._batch_rule_for(16, FakeMesh()) == ("data",)
    assert tsteps._batch_rule_for(1, FakeMesh()) is None


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("shape_name,kind", [
    ("train_4k", "train"), ("prefill_32k", "prefill"),
    ("decode_32k", "decode")])
def test_build_cell_matches_reference(host_mesh, shape_name, kind):
    jcell = jsteps.build_cell(jcfgs.get_config("llama3.2-1b"),
                              jcfgs.SHAPES[shape_name], j_host_mesh())
    tcell = tsteps.build_cell(tcfgs.get_config("llama3.2-1b"),
                              tcfgs.SHAPES[shape_name], host_mesh)
    assert tcell.kind == jcell.kind == kind
    assert tcell.donate_argnums == jcell.donate_argnums
    assert tcell.fsdp == jcell.fsdp
    assert tcell.rules == jcell.rules
    assert len(tcell.args) == len(jcell.args) == len(tcell.in_shardings)
    for targ, jarg, tsh, jsh in zip(tcell.args, jcell.args,
                                    tcell.in_shardings, jcell.in_shardings):
        ta, ja = _flat(targ), _flat(jarg)
        assert sorted(ta) == sorted(ja)
        ts, js = _flat(tsh), _flat(jsh)
        for k, t in ta.items():
            assert t.is_meta, k
            assert tuple(t.shape) == ja[k].shape, k
            assert str(t.dtype).removeprefix("torch.") == str(ja[k].dtype), k
            assert ts[k].spec == tuple(js[k].spec), k


def test_materialized_train_cell_takes_the_train_step(host_mesh):
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import make_train_step

    cfg = tcfgs.smoke_config("llama3.2-1b")
    cell = tsteps.build_cell(cfg, ShapeConfig("tiny", 32, 2, "train"),
                             host_mesh)
    params, opt, batch = tsteps.materialize(cell, "cpu", seed=3)
    again = tsteps.materialize(cell, "cpu", global_batch=4, seed=3)
    assert all(torch.equal(params[k], again[0][k]) for k in params)
    assert again[2]["tokens"].shape == (4, 32)
    copy = {k: p.detach().clone().requires_grad_(True)
            for k, p in params.items()}
    copy_opt = {"opt": {"m": {k: t.clone() for k, t in opt["opt"]["m"].items()},
                        "v": {k: t.clone() for k, t in opt["opt"]["v"].items()},
                        "step": opt["opt"]["step"].clone()}}
    with sharding_ctx(host_mesh, cell.rules):
        p1, o1, m1 = cell.step(params, opt, batch)
    p2, o2, m2 = make_train_step(cell.model, OptimizerConfig())(
        copy, copy_opt, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
        assert torch.equal(o1["opt"]["m"][k], o2["opt"]["m"][k]), k


def test_materialized_serving_cells_hold_the_serving_cast(host_mesh):
    cfg = tcfgs.smoke_config("llama3.2-1b").with_updates(dtype="bfloat16")
    cell = tsteps.build_cell(cfg, ShapeConfig("tiny", 32, 2, "decode"),
                             host_mesh)
    params, cache, batch = tsteps.materialize(cell, "cpu")
    for k, p in params.items():
        assert p.dtype == cell.model.serving_cast(k, p.float()).dtype, k
    assert int(cache["pos"]) == 31 and cache["k"].dtype == torch.bfloat16
    assert batch["token"].dtype == torch.int32
    logits, _ = cell.step(params, cache, batch)
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()


def test_elastic_reshard_roundtrip(tmp_path, host_mesh):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.modeling.registry import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import LoopConfig, train

    cfg = tcfgs.smoke_config("llama3.2-1b").with_updates(
        n_layers=2, d_model=32, d_ff=64, vocab=64, n_heads=2, n_kv_heads=2,
        head_dim=16)
    model = build_model(cfg)
    train(model, make_pipeline(cfg, seq_len=16, global_batch=2, seed=0),
          LoopConfig(steps=4, log_every=100, ckpt_every=2,
                     ckpt_dir=str(tmp_path)),
          OptimizerConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=4),
          device="cpu")
    out = elastic_restore(str(tmp_path), model, cfg, host_mesh)
    assert out is not None
    step, params, state = out
    assert step == 4
    _, tree = ckpt.restore_latest(str(tmp_path))
    rules = make_rules(cfg, host_mesh)
    specs = model.param_specs()
    for k, v in params.items():
        assert isinstance(v, DTensor), k
        assert tuple(v.placements) == \
            Sharding(host_mesh, spec_for(specs[k].axes, rules)).placements
        assert torch.equal(v.to_local(), tree["params"][k]), k
        assert torch.equal(state["opt"]["m"][k].to_local(),
                           tree["state"]["opt"]["m"][k]), k
    assert int(state["opt"]["step"]) == 4
    assert elastic_restore(str(tmp_path / "none"), model, cfg,
                           host_mesh) is None


# ------------------------------------------------------------ dry-run FLOPs
def _plain_flops(cell, args) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        cell.step(*args)
    return float(counter.get_total_flops())


KINDS = ("train", "prefill", "decode")
FLOP_CELLS = [(a, k) for a in ("llama3.2-1b", "mamba2-780m",
                               "recurrentgemma-9b", "olmoe-1b-7b")
              for k in KINDS] + [("internvl2-26b", k) for k in KINDS] + [
    ("hubert-xlarge", "train"), ("hubert-xlarge", "prefill")]


@pytest.mark.parametrize("arch,kind", FLOP_CELLS)
def test_counting_mode_plus_flop_counter_equals_plain_path(host_mesh, arch,
                                                           kind):
    cfg = tcfgs.smoke_config(arch)
    cell = tsteps.build_cell(cfg, ShapeConfig("tiny", 40, 2, kind),
                             host_mesh)
    args = tsteps.materialize(cell, "cpu")
    with kernels.recording() as launched:
        want = _plain_flops(cell, args)
    assert not launched
    got = cost_analysis.count_flops(cell)
    dense = sum(got["kernel_dense_flops"].values())
    # a Mamba-2 decode step runs no kernel (its recurrence is one step)
    assert bool(got["kernel_calls"]) != (cfg.family == "ssm"
                                         and kind == "decode")
    assert got["dot_flops"] + dense == pytest.approx(want, rel=1e-9)
    assert got["flops"] == got["dot_flops"] + sum(
        got["kernel_flops"].values())
    # the fake run left no fake tensor in the model's per-device caches
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.modeling import layers

    assert not any(isinstance(t, FakeTensor)
                   for t in layers._FREQS.values())


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (40, 40, True, 0), (40, 40, True, 16), (33, 33, False, 0),
    (17, 40, True, 0), (40, 17, True, 5), (24, 24, False, 7)])
def test_attention_work_counts_live_pairs(Sq, Skv, causal, window):
    from repro_torch.kernels.flash_attention.kernel import _mask

    pairs = int(_mask(Sq, Skv, causal, window, "cpu").sum())
    assert flops.live_pairs(Sq, Skv, causal, window) == pairs
    assert flops.attention(2, 4, Sq, Skv, 16, causal, window)[0] == \
        4.0 * 2 * 4 * pairs * 16


def test_ssd_backward_work_is_the_bound_of_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for b, H, S, hd, ds, Q in ((2, 48, 2048, 64, 128, 128),
                               (1, 4, 300, 8, 16, 128)):
        want = cs.k6b_bound(b, H, S, hd, ds, min(Q, S), 1.0, True)[0]
        assert flops.ssd_bwd(b, H, S, hd, ds, Q)[0] == pytest.approx(want)


def test_counting_branch_takes_only_fake_or_meta_tensors():
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd

    q = torch.randn(1, 2, 8, 16)
    k = torch.randn(1, 1, 8, 16)
    with kernels.counting() as kc:
        out = flash_attention_bhsd(q, k, k)
        assert not kc and torch.isfinite(out).all()
        meta = [t.to("meta") for t in (q, k, k)]
        out = flash_attention_bhsd(*meta)
        assert out.is_meta and out.shape == q.shape
    assert kc["flash_attention"]["calls"] == 1
    assert kernels.launch_counts()["flash_attention"] == 0


# ---------------------------------------------------------------- dry run
def test_dryrun_listing_matches_reference():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert dryrun.main(["--list", "--all"]) == 0
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--list", "--all"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "PATH": "/usr/bin:/bin"})
    assert ref.returncode == 0, ref.stderr
    assert buf.getvalue() == ref.stdout
    assert list(dryrun.iter_cells()) == [
        (a, s, c is None) for a in sorted(jcfgs.ARCHS)
        for s, c in jcfgs.applicable_shapes(jcfgs.get_config(a)).items()]


def test_dryrun_analyses_a_production_cell(tmp_path):
    try:
        res = dryrun.run_cell("llama3.2-1b", "decode_32k", multi_pod=False,
                              out_dir=str(tmp_path))
    finally:
        destroy_group()
    assert res["devices"] == 256 and res["kind"] == "decode"
    assert res["hlo"]["kernel_calls"] == {"decode_attention": 16}
    mem = res["memory"]
    # the KV cache: (16, 128, 32768, 8, 64) bf16 twice, its KV sequence over
    # the 16-way model axis (8 KV heads cannot split 16 ways) and the
    # batch over the 16-way data axis
    assert mem["cache_bytes"] == 2 * 16 * 8 * 2048 * 8 * 64 * 2 + 4
    assert mem["peak_bytes_estimate"] > mem["argument_bytes"]
    assert (tmp_path / "llama3.2-1b_decode_32k_pod.json").exists()
    print(dryrun._fmt(res))
