"""The port's training path against the JAX package's, on the CPU.

At the sizes of ``tests/test_training.py`` (a 2-layer llama of width 32;
the smoke configs of the three families), with the JAX parameters carried
across (``modeling.convert.lm_params_from_numpy``) and inputs made with
numpy from a seed:

- ``LM.loss``, ``MambaLM.loss`` and ``GriffinLM.loss``: the value and every
  parameter's gradient against ``jax.value_and_grad(model.loss)``, under
  ``remat`` "none" and "full" (the two equal), and "dots";
- ``adamw_update`` (in place), ``lr_schedule`` and ``clip_by_global_norm``
  against the reference on random trees;
- the data pipelines, batch for batch bit-equal;
- checkpoints crossing the two packages both ways (the port resumes a JAX
  run's checkpoint and continues it);
- ``topk`` compression against the reference, ``int8`` error feedback and
  the byte accounting;
- 4 steps of ``make_train_step`` against the reference's jitted step, with
  and without ``microbatch=2`` and with ``topk`` compression;
- the loop: the loss falls over 30 steps, a restart from a checkpoint
  matches the uninterrupted run, a failure without a checkpoint raises, and
  the CLI trains and restarts on the CPU.

Tolerances: 1e-4 for losses, gradients and parameters (float32; XLA and
PyTorch sum in different orders), 1e-6 for the optimizer's arithmetic on
the same inputs; bit-equality for data and checkpoints.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import compression as jcomp
from repro.modeling.registry import build_model as jax_build_model
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.configs import smoke_config
from repro_torch.distributed import compression as comp
from repro_torch.launch import train as train_cli
from repro_torch.modeling.convert import lm_params_from_numpy
from repro_torch.modeling.registry import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (
    FailureInjector,
    LoopConfig,
    SimulatedFailure,
    init_train_state,
    make_train_step,
    run_with_restarts,
    train,
)

TOL = 1e-4
OPT_TOL = 1e-6
CPU = "cpu"
TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab=64, n_heads=2,
            n_kv_heads=2, head_dim=16)


def _tiny(steps=8, ckpt_dir=None, ckpt_every=4, compression="none", **upd):
    """The port's and the reference's ``_tiny_setup``: (cfg, model,
    pipeline, loop, opt) for each package."""
    out = []
    for smoke, build, pipe, loop_t, comp_t, opt_t in (
            (smoke_config, build_model, data.make_pipeline, LoopConfig,
             comp.CompressionConfig, opt.OptimizerConfig),
            (jax_smoke_config, jax_build_model, jdata.make_pipeline,
             jloop.LoopConfig, jcomp.CompressionConfig,
             jopt.OptimizerConfig)):
        cfg = smoke("llama3.2-1b").with_updates(**TINY, **upd)
        out.append((cfg, build(cfg), pipe(cfg, seq_len=16, global_batch=2,
                                          seed=0),
                    loop_t(steps=steps, log_every=100, ckpt_every=ckpt_every,
                           ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
                           compression=comp_t(scheme=compression)),
                    opt_t(peak_lr=1e-3, warmup_steps=2, decay_steps=steps)))
    return out


def _carry(cfg, jparams):
    params = lm_params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device=CPU)
    for p in params.values():
        p.requires_grad_(True)
    return params


def _batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


# -------------------------------------------------------------------- losses
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_model_loss_and_grads_match_reference(arch, rng):
    jcfg = jax_smoke_config(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(3))
    S = 24
    toks = rng.integers(0, jcfg.vocab, size=(2, S)).astype(np.int32)
    tgts = rng.integers(0, jcfg.vocab, size=(2, S)).astype(np.int32)
    mask = (rng.random((2, S)) < 0.9).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts),
              "loss_mask": jnp.asarray(mask)}
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams,
                                                                 jbatch)
    batch = {"tokens": torch.as_tensor(toks), "targets": torch.as_tensor(tgts),
             "loss_mask": torch.as_tensor(mask)}
    per_remat = {}
    for remat in ("none", "full", "dots"):
        cfg = smoke_config(arch).with_updates(remat=remat)
        params = _carry(cfg, jparams)
        loss, met = build_model(cfg).loss(params, batch)
        keys = sorted(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        assert set(met) == set(jm)
        np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL)
        for k, g in zip(keys, grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), atol=TOL,
                                       err_msg=f"{arch} {remat} {k}")
        per_remat[remat] = (loss.item(), [g.numpy() for g in grads])
    # checkpointing recomputes the same operations: the same bits
    for remat in ("full", "dots"):
        assert per_remat[remat][0] == per_remat["none"][0]
        for a, b in zip(per_remat[remat][1], per_remat["none"][1]):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- optimizer
def _tree(rng, dtype=np.float32):
    return {"b/w": rng.normal(size=(7, 5)).astype(dtype),
            "a/s": rng.normal(size=(9,)).astype(dtype),
            "c/k": rng.normal(size=(3, 2, 4)).astype(dtype)}


def test_lr_schedule_matches_reference():
    cfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=10,
                              decay_steps=100, min_lr_frac=0.1)
    jcfg = jopt.OptimizerConfig(peak_lr=1e-3, warmup_steps=10,
                                decay_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 250):
        got = opt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jopt.lr_schedule(
            jcfg, jnp.asarray(step, jnp.int32))), rtol=OPT_TOL)
    assert float(opt.lr_schedule(cfg, 0)) == 0.0


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm, rng):
    g = _tree(rng)
    got, norm = opt.clip_by_global_norm(
        {k: torch.as_tensor(v) for k, v in g.items()}, max_norm)
    want, jnorm = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=OPT_TOL)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=OPT_TOL, atol=OPT_TOL)


def test_adamw_update_matches_reference(rng):
    """Three steps from a random state; the port updates in place."""
    cfg = opt.OptimizerConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10,
                              grad_clip=0.5)
    jcfg = jopt.OptimizerConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10,
                                grad_clip=0.5)
    p0 = _tree(rng)
    params = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, jstate = opt.init_opt_state(params), jopt.init_opt_state(jparams)
    for _ in range(3):
        g = _tree(rng)
        ids = {k: id(t) for k, t in params.items()}
        params, state, met = opt.adamw_update(
            params, {k: torch.as_tensor(v) for k, v in g.items()}, state, cfg)
        assert {k: id(t) for k, t in params.items()} == ids  # in place
        jparams, jstate, jmet = jopt.adamw_update(
            jparams, {k: jnp.asarray(v) for k, v in g.items()}, jstate, jcfg)
        for k in p0:
            for a, b in ((params[k], jparams[k]), (state["m"][k], jstate["m"][k]),
                         (state["v"][k], jstate["v"][k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=OPT_TOL, atol=OPT_TOL)
        assert int(state["step"]) == int(jstate["step"])
        assert state["step"].dtype == torch.int32
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=OPT_TOL)


# ---------------------------------------------------------------------- data
def test_pipelines_bit_equal_to_reference():
    pc = data.DataConfig(seq_len=33, global_batch=3, vocab=500, seed=4,
                         doc_len_mean=8)
    jc = jdata.DataConfig(seq_len=33, global_batch=3, vocab=500, seed=4,
                          doc_len_mean=8)
    pipe, jpipe = data.TokenPipeline(pc), jdata.TokenPipeline(jc)
    for step in (0, 1, 17):
        for a, b in ((pipe.batch(step), jpipe.batch(step)),
                     (pipe.host_batch(step, 1, 3), jpipe.host_batch(step, 1, 3))):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    audio = data.AudioPipeline(16, 2, 10, 6, seed=2).batch(5)
    jaudio = jdata.AudioPipeline(16, 2, 10, 6, seed=2).batch(5)
    for k in audio:
        np.testing.assert_array_equal(audio[k], jaudio[k])
    cfg = smoke_config("llama3.2-1b")
    a = data.make_pipeline(cfg, 16, 2, seed=1).batch(3)
    b = jdata.make_pipeline(jax_smoke_config("llama3.2-1b"), 16, 2,
                            seed=1).batch(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


# --------------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    state = {"a": {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
             "c": torch.tensor(3.5)}
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), step, state, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    step, tree = ckpt.restore_latest(str(tmp_path))
    assert step == 4 and torch.equal(tree["a"]["b"], state["a"]["b"])
    assert float(tree["c"]) == 3.5
    assert sorted(d.name for d in tmp_path.iterdir()
                  if d.name.startswith("step_")) == ["step_000000003",
                                                     "step_000000004"]


def test_checkpoints_cross_both_packages(tmp_path):
    """A port checkpoint restores in the reference bit for bit; a JAX run's
    checkpoint restores in the port, which resumes and finishes the run
    within 1e-4 of the JAX run's own losses."""
    (cfg, model, pipe, loop, ocfg), (jcfg, jmodel, jpipe, jl, jo) = _tiny(
        steps=4, ckpt_dir=tmp_path / "port", ckpt_every=2)
    train(model, pipe, loop, ocfg, seed=0, device=CPU)
    pstep, ptree = ckpt.restore_latest(str(tmp_path / "port"))
    jstep, jtree = jckpt.restore_latest(str(tmp_path / "port"))
    assert pstep == jstep == 4
    flat = ckpt._flatten(ptree)
    jflat = jckpt._flatten(jtree)
    assert set(flat) == set(jflat) and "state|opt|step" in flat
    for k, v in flat.items():
        assert v.numpy().dtype == jflat[k].dtype
        np.testing.assert_array_equal(v.numpy(), jflat[k])

    # the JAX run, interrupted after 2 steps, then finished by the port
    _, (_, _, _, jl_full, _) = _tiny(steps=4)
    jref = jloop.train(jmodel, jpipe, jl_full, jo, key=jax.random.key(0))
    _, (_, _, _, jl_half, _) = _tiny(steps=2, ckpt_dir=tmp_path / "jax",
                                     ckpt_every=2)
    jloop.train(jmodel, jpipe, jl_half, jo, key=jax.random.key(0))
    loop.ckpt_dir = str(tmp_path / "jax")
    res = train(model, pipe, loop, ocfg, device=CPU)
    assert res.final_step == 4 and len(res.losses) == 2
    np.testing.assert_allclose(res.losses, jref.losses[2:], rtol=TOL)


# --------------------------------------------------------------- compression
def test_topk_matches_reference(rng):
    g = {k: v * 3 for k, v in _tree(rng).items()}
    e = {k: rng.normal(size=v.shape).astype(np.float32) * 0.1
         for k, v in g.items()}
    cfg = comp.CompressionConfig(scheme="topk", topk_frac=0.2)
    out, err = comp.compress_decompress(
        {k: torch.as_tensor(v) for k, v in g.items()},
        {k: torch.as_tensor(v) for k, v in e.items()}, cfg, step=3)
    jout, jerr = jcomp.compress_decompress(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in e.items()},
        jcomp.CompressionConfig(scheme="topk", topk_frac=0.2), step=3)
    for k in g:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
        np.testing.assert_array_equal(err[k].numpy(), np.asarray(jerr[k]))
        assert int((out[k] != 0).sum()) == int(np.ceil(g[k].size * 0.2))


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compression_error_feedback_accumulates(scheme, rng):
    grads = {"w": torch.as_tensor(rng.normal(size=(64, 8)),
                                  dtype=torch.float32)}
    cfg = comp.CompressionConfig(scheme=scheme, topk_frac=0.1)
    out, new_err = comp.compress_decompress(
        grads, comp.init_error_state(grads), cfg, step=0)
    np.testing.assert_allclose((out["w"] + new_err["w"]).numpy(),
                               grads["w"].numpy(), rtol=1e-5, atol=1e-6)
    if scheme == "int8":
        scale = float(grads["w"].abs().max()) / 127.0
        q = out["w"] / scale  # integer levels, within one of the value
        np.testing.assert_allclose(q.numpy(), np.round(q.numpy()), atol=1e-3)
        assert float((q - grads["w"] / scale).abs().max()) <= 1.0 + 1e-4
        # the noise is a function of (seed, step, tensor index)
        again, _ = comp.compress_decompress(
            grads, comp.init_error_state(grads), cfg, step=0)
        other, _ = comp.compress_decompress(
            grads, comp.init_error_state(grads), cfg, step=1)
        assert torch.equal(again["w"], out["w"])
        assert not torch.equal(other["w"], out["w"])


def test_compressed_bytes_match_reference():
    params = {"w": torch.zeros(1000), "b": torch.zeros((4, 6))}
    jparams = {"w": jnp.zeros((1000,)), "b": jnp.zeros((4, 6))}
    for scheme in ("none", "topk", "int8"):
        assert comp.compressed_bytes(
            params, comp.CompressionConfig(scheme=scheme)) == \
            jcomp.compressed_bytes(jparams,
                                   jcomp.CompressionConfig(scheme=scheme))
    assert comp.compressed_bytes(
        {"w": torch.zeros(1000)},
        comp.CompressionConfig(scheme="topk", topk_frac=0.05)) == 400


# ---------------------------------------------------------------- train step
@pytest.mark.parametrize("microbatch,compression", [(1, "none"), (2, "none"),
                                                    (1, "topk")])
def test_train_steps_match_reference(microbatch, compression):
    (cfg, model, pipe, loop, ocfg), (jcfg, jmodel, jpipe, jl, jo) = _tiny(
        microbatch=microbatch, compression=compression)
    jparams = jmodel.init(jax.random.key(0))
    jstate = {"opt": jopt.init_opt_state(jparams)}
    params = _carry(cfg, jparams)
    _, state = init_train_state(model, torch.Generator().manual_seed(0), CPU,
                                loop.compression)
    if compression != "none":
        jstate["err"] = jcomp.init_error_state(jparams)
    jstep = jax.jit(jloop.make_train_step(jmodel, jo, jl.compression))
    step = make_train_step(model, ocfg, loop.compression)
    for i in range(4):
        jparams, jstate, jmet = jstep(jparams, jstate, jpipe.batch(i))
        params, state, met = step(params, state, _batch(pipe.batch(i)))
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=TOL, err_msg=f"step {i} {key}")
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                   atol=TOL, err_msg=k)
    assert int(state["opt"]["step"]) == 4


# ---------------------------------------------------------------------- loop
def test_training_loss_decreases():
    (cfg, model, pipe, loop, ocfg), _ = _tiny(steps=30)
    res = train(model, pipe, loop, ocfg, seed=1, device=CPU)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
    assert len(res.step_s) == 30


def test_restart_matches_uninterrupted_run(tmp_path):
    """Kill at step 6, restart from the step-6 checkpoint: the same losses
    as a run that was never interrupted (on the CPU, bit for bit)."""
    (cfg, model, pipe, loop, ocfg), _ = _tiny(steps=10, ckpt_dir=tmp_path,
                                              ckpt_every=2)
    ref = train(model, pipe, LoopConfig(steps=10, log_every=100,
                                        ckpt_every=1000), ocfg, seed=0,
                device=CPU)
    res = run_with_restarts(model, pipe, loop, ocfg, seed=0,
                            injector=FailureInjector(fail_at=6), device=CPU)
    assert res.restarts == 1 and res.final_step == 10
    np.testing.assert_allclose(res.losses[-3:], ref.losses[-3:], rtol=1e-5)
    assert res.losses[-4:] == ref.losses[-4:]


def test_failure_without_checkpoint_raises():
    (cfg, model, pipe, loop, ocfg), _ = _tiny(steps=10)
    with pytest.raises(SimulatedFailure):
        run_with_restarts(model, pipe, loop, ocfg,
                          injector=FailureInjector(fail_at=3),
                          max_restarts=0, device=CPU)


def test_train_with_int8_compression_runs():
    (cfg, model, pipe, loop, ocfg), _ = _tiny(steps=6, compression="int8")
    res = train(model, pipe, loop, ocfg, seed=2, device=CPU)
    assert len(res.losses) == 6 and np.all(np.isfinite(res.losses))


def test_train_cli_restarts_on_cpu(tmp_path, capsys):
    assert train_cli.main(["--smoke", "--device", "cpu", "--steps", "6",
                           "--batch", "2", "--seq", "16", "--ckpt-dir",
                           str(tmp_path), "--ckpt-every", "2",
                           "--fail-at", "3"]) == 0
    out = capsys.readouterr().out
    assert "restart #1" in out and "resumed from step 2" in out
    assert "done: step=6" in out and "restarts=1" in out


def test_train_cli_trains_moe_on_cpu(capsys):
    """The MoE family through the CLI: olmoe-1b-7b's smoke config."""
    assert train_cli.main(["--arch", "olmoe-1b-7b", "--smoke", "--device",
                           "cpu", "--steps", "3", "--batch", "2", "--seq",
                           "16"]) == 0
    out = capsys.readouterr().out
    assert "family=moe" in out and "done: step=3" in out


def test_train_needs_a_device_or_cpu():
    """Without ``device="cpu"`` the loop runs on the card, and raises where
    there is none (checked before any work)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    (cfg, model, pipe, loop, ocfg), _ = _tiny(steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(model, pipe, loop, ocfg)
