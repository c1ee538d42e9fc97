"""The port's audio encoder (``repro_torch.modeling.encoder``) against the JAX
package's, on the CPU.

At ``smoke_config("hubert-xlarge")`` (2 layers, width 64, 4 heads of 16,
16-dim frame features), with the JAX parameters carried across
(``modeling.convert.lm_params_from_numpy``) and frames, masks and targets
made with numpy from a seed:

- ``layers.sinusoidal_positions`` bit-equal to the reference's, in float32
  and bf16;
- ``param_specs`` (paths, shapes, init kinds, scales) and the parameter
  count equal to the reference's, at smoke size and at full size
  (945,280,000);
- ``encode`` / ``prefill`` logits with a mask and without one, ``loss``
  and every parameter's gradient (the train step's ``_value_and_grad``
  against ``jax.value_and_grad``) under ``remat`` "none" and "full" (the two
  bit-equal), and all of it again at head_dim 80, the full model's;
- the serving path: ``make_compiled_steps`` builds a bf16 encoder (its
  top-level ``mask_emb`` through ``serving_cast``) and encodes a frames
  batch, the decode step raises, and the training CLI trains the encoder.

Tolerance: ``LM_TOL`` 1e-4 in float32 (XLA and PyTorch sum in different
orders), as for the other families.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.modeling import layers as jax_layers
from repro.modeling.registry import build_model as jax_build_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import train as train_cli
from repro_torch.modeling import layers
from repro_torch.modeling.convert import lm_params_from_numpy
from repro_torch.modeling.encoder import AudioEncoder
from repro_torch.modeling.registry import build_model
from repro_torch.serving.engine import make_compiled_steps, serving_bytes
from repro_torch.training.train_loop import _value_and_grad

ARCH = "hubert-xlarge"
LM_TOL = 1e-4
HD80 = dict(head_dim=80, n_heads=2, n_kv_heads=2)


def _models(**upd):
    """(port cfg, port model, JAX model, JAX params, port params) at the
    smoke size with ``upd``."""
    jcfg = jax_smoke_config(ARCH).with_updates(**upd)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(7))
    cfg = smoke_config(ARCH).with_updates(**upd)
    params = lm_params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return cfg, build_model(cfg), jmodel, jparams, params


def _batch(rng, cfg, B=2, S=24, masked=True):
    """The same frames (and mask, targets) for both packages."""
    arrays = {"frames": rng.normal(size=(B, S, cfg.frame_feat_dim))
              .astype(np.float32),
              "targets": rng.integers(0, cfg.vocab, size=(B, S))
              .astype(np.int32)}
    if masked:
        arrays["mask"] = (rng.random((B, S)) < 0.3).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(v) for k, v in arrays.items()})


# ---------------------------------------------------------------- positions
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_positions_bit_equal(dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    for S, d in ((1, 64), (24, 64), (781, 1280), (4096, 1280)):
        got = layers.sinusoidal_positions(S, d, td)
        want = jax_layers.sinusoidal_positions(S, d, jd)
        assert got.dtype == td and tuple(got.shape) == (S, d)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# -------------------------------------------------------------------- specs
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_specs_match_reference(size):
    """Paths, shapes, init kinds and scales as the reference declares them;
    945,280,000 parameters at full size (48 layers of 19,665,920, the
    512 -> 1280 frontend and the 1280 x 512 head)."""
    get, jget = ((smoke_config, jax_smoke_config) if size == "smoke"
                 else (get_config, jax_get_config))
    model, jmodel = build_model(get(ARCH)), jax_build_model(jget(ARCH))
    specs, jspecs = model.param_specs(), jmodel.param_specs()
    assert set(specs) == set(jspecs)
    for path, s in specs.items():
        j = jspecs[path]
        assert (s.shape, s.axes, s.init, s.scale) == \
            (tuple(j.shape), tuple(j.axes), j.init, j.scale), path
    assert model.param_count() == jmodel.param_count()
    if size == "full":
        assert model.param_count() == 945_280_000


def test_converter_checks_encoder_params():
    """``lm_params_from_numpy`` goes through the encoder's ``param_specs``:
    a dict without the top-level ``mask_emb`` is refused."""
    cfg = smoke_config(ARCH)
    specs = build_model(cfg).param_specs()
    arrays = {k: np.zeros(v.shape, np.float32) for k, v in specs.items()}
    assert set(lm_params_from_numpy(cfg, arrays)) == set(specs)
    with pytest.raises(KeyError, match="mask_emb"):
        lm_params_from_numpy(cfg, {k: v for k, v in arrays.items()
                                   if k != "mask_emb"})


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("upd", [{}, HD80], ids=["smoke", "head_dim80"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_encode_matches_reference(rng, upd, masked):
    cfg, model, jmodel, jparams, params = _models(**upd)
    jb, tb = _batch(rng, cfg, masked=masked)
    want = np.asarray(jmodel.encode(jparams, jb))
    with torch.no_grad():
        got = model.encode(params, tb)
        logits, cache = model.prefill(params, tb)
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=LM_TOL)
    assert cache is None and torch.equal(logits, got)
    jl, jc = jmodel.prefill(jparams, jb)
    assert jc is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=LM_TOL)


@pytest.mark.parametrize("upd", [{}, HD80], ids=["smoke", "head_dim80"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_loss_and_grads_match_reference(rng, upd, masked):
    """The loss and every parameter's gradient, under remat "none" and
    "full" (which recompute the same operations: the same bits)."""
    cfg, _, jmodel, jparams, _ = _models(**upd)
    jb, tb = _batch(rng, cfg, masked=masked)
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jb)
    runs = {}
    for remat in ("none", "full"):
        rcfg = cfg.with_updates(remat=remat)
        params = lm_params_from_numpy(
            rcfg, {k: np.asarray(v) for k, v in jparams.items()})
        for p in params.values():
            p.requires_grad_(True)
        # the train step's own gradient: mask_emb, unread without a mask,
        # gets a zero gradient there, as under jax.grad
        (loss, met), grad = _value_and_grad(build_model(rcfg), params, tb)
        assert set(met) == set(jm) == {"xent"}
        np.testing.assert_allclose(loss.item(), float(jl), rtol=LM_TOL)
        assert set(grad) == set(jg)
        for k, g in grad.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                       atol=LM_TOL, err_msg=f"{remat} {k}")
        runs[remat] = (loss.item(), grad)
    assert runs["full"][0] == runs["none"][0]
    for k, g in runs["none"][1].items():
        assert torch.equal(runs["full"][1][k], g), k
    # mask_emb is read only where the batch masks frames
    assert bool(runs["none"][1]["mask_emb"].any()) == masked


def test_decode_step_raises():
    cfg, model, *_ = _models()
    with pytest.raises(NotImplementedError, match="no decode step"):
        model.decode_step({}, None, {})


# ------------------------------------------------------------------ serving
def test_serving_cast_casts_top_level_params():
    """``serving_cast`` of a path without ``/`` (``mask_emb``, which the
    model uses in ``cfg.dtype``) casts it; it used to index past the
    path's parts. ``serving_bytes`` of the full model reads every path:
    bf16 for all but the 98 layer norms' 250,880 float32 parameters."""
    model = build_model(get_config(ARCH))
    probe = torch.zeros(3)
    assert model.serving_cast("mask_emb", probe).dtype == torch.bfloat16
    assert model.serving_cast("ln_f/scale", probe).dtype == torch.float32
    assert model.serving_cast("layers/ln_mlp/bias", probe).dtype == \
        torch.float32
    assert model.serving_cast("head/w", probe).dtype == torch.bfloat16
    norms = 2 * 1280 * (2 * 48 + 1)
    assert serving_bytes(get_config(ARCH)) == \
        2 * 945_280_000 + 2 * norms


def test_compiled_steps_encode_frames_on_cpu(rng):
    """The executor-facing entry point serves the encoder: bf16 parameters
    (norms float32), a prefill step taking a frames batch and returning
    float32 frame logits with no cache, equal to ``encode`` on the same
    parameters; the decode step raises."""
    cfg = smoke_config(ARCH).with_updates(dtype="bfloat16")
    model, params, prefill_fn, decode_fn = make_compiled_steps(
        cfg, seed=3, device="cpu")
    assert isinstance(model, AudioEncoder)
    for path, t in params.items():
        want = torch.float32 if "ln_" in path else torch.bfloat16
        assert t.dtype == want, path
    _, tb = _batch(rng, cfg, S=40, masked=False)
    logits, cache = prefill_fn(params, {"frames": tb["frames"]})
    assert cache is None and logits.dtype == torch.float32
    assert logits.shape == (2, 40, cfg.vocab)
    assert torch.isfinite(logits).all()
    assert torch.equal(logits, model.encode(params, {"frames": tb["frames"]}))
    with pytest.raises(NotImplementedError):
        decode_fn(params, cache, {"token": torch.zeros(2, dtype=torch.int32)})


def test_train_cli_trains_hubert_on_cpu(capsys):
    """``launch/train.py --arch hubert-xlarge`` through ``make_pipeline``'s
    ``AudioPipeline``: the masked-prediction loss falls."""
    assert train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "20", "--batch", "4", "--seq",
                           "64"]) == 0
    out = capsys.readouterr().out
    assert "family=audio" in out and "done: step=20" in out
    first, last = (float(x) for x in
                   out.split("loss[first→last]=")[1].split()[0].split("→"))
    assert np.isfinite([first, last]).all() and last < first
