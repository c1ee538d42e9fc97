"""The port's MoE layer and the rest of the decoder family against the JAX
package's, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its port, the JAX parameters carried across by
``modeling.convert.lm_params_from_numpy``:

- ``moe_apply`` at smoke size with top-1 and top-2 routing, gated and plain
  activations, a capacity small enough that assignments are dropped, tied
  router columns (the lower expert index wins, as in ``jax.lax.top_k``) and
  ``moe_batch_groups``: the output and the aux loss, and the routing exact
  (the dispatch tensor, every expert's slot of every kept assignment, equal
  to the reference's, read through its ``shard_fn`` hook);
- the olmoe-1b-7b and llama4-maverick (shared expert) smoke LMs: prefill,
  decode past the cache, ``forward``, ``loss`` (xent and aux) and every
  gradient against ``jax.value_and_grad``;
- ``param_count`` and ``active_param_count`` at smoke size and for the full
  configs (from the specs alone);
- the grouped ``moe_every`` layout (a dataclass subclass of each package's
  ``ArchConfig`` adds the field the reference reads with ``getattr``):
  params, forward, loss, prefill and decode, and the cache's layer order;
- the int8 KV cache (``kv_quant``): ``kv_quantize`` bit-equal to the
  reference's (round half to even), the prefill's int8 cache and scales
  bit-equal to the reference's quantization of the same K/V, and over a
  prefill and 4 decode steps the caches against the reference's (scales
  within 1e-4, int8 values off by one only on rounding boundaries) and
  logits within 1e-4; the grouped layout with ``kv_quant`` refused;
- the internvl2 smoke LM with ``vision_embeds``: forward, loss, prefill and
  decode.

Tolerances: float32 within 1e-4 of max(1, |reference|) (summation order
differs between XLA and PyTorch); routing exact; int8 caches exact on the
same float K/V.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.modeling import lm as jax_lm
from repro.modeling import moe as jax_moe
from repro.modeling.registry import build_model as jax_build_model
from repro_torch.configs import base
from repro_torch.configs import get_config, smoke_config
from repro_torch.modeling import lm, moe
from repro_torch.modeling.convert import lm_params_from_numpy
from repro_torch.modeling.registry import build_model

TOL = 1e-4


def _close(got, want, what=""):
    """|got - want| within TOL of max(1, |want|)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def _both(name, **kw):
    return (smoke_config(name).with_updates(**kw),
            jax_smoke_config(name).with_updates(**kw))


def _carried(cfg, jcfg, seed=0):
    """The JAX model and params, and the port's model with the same
    params."""
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    params = lm_params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, build_model(cfg), params


# ------------------------------------------------------------ the MoE layer
def _moe_params(cfg, rng, tie=None):
    """Random MoE params for ``cfg`` (numpy). With ``tie``, those router
    columns are one positive column and the others are small, so that for
    positive inputs the tied experts lead every token's probabilities."""
    out = {}
    for name, spec in moe.moe_specs(cfg).items():
        out[name] = rng.normal(size=spec.shape).astype(np.float32) \
            / np.sqrt(spec.shape[-2])
    if tie is not None:
        out["router/w"] *= 0.01
        col = np.abs(rng.normal(size=cfg.d_model)).astype(np.float32)
        for e in tie:
            out["router/w"][:, e] = col
    return out


def _ref_moe(jcfg, params, x):
    """The reference's (y, aux, dispatch): the dispatch tensor is the first
    array its ``shard_fn`` sees."""
    seen = []

    def shard(a, axes):
        seen.append(a)
        return a

    y, aux = jax_moe.moe_apply(jcfg, {k: jnp.asarray(v)
                                      for k, v in params.items()},
                               jnp.asarray(x), shard_fn=shard)
    return np.asarray(y), float(aux), np.asarray(seen[0])


def _port_moe(cfg, p, x, monkeypatch):
    """The port's (y, aux) and its dispatch tensor, the expert index and
    ``keep`` of the router call ``moe_apply`` makes."""
    seen = []
    route = moe._route

    def recording(*args):
        seen.append(route(*args))
        return seen[-1]

    monkeypatch.setattr(moe, "_route", recording)
    y, aux = moe.moe_apply(cfg, p, x)
    (_, _, idx, keep, eoh, poh), = seen
    return y, aux, torch.einsum("bngke,bngkc->bngec", eoh, poh), idx, keep


MOE_CASES = [
    # (id, config updates, B, S, tied router columns)
    ("top1-swiglu", dict(top_k=1), 2, 24, None),
    ("top2-swiglu", dict(top_k=2), 2, 32, None),
    ("top2-gelu", dict(top_k=2, act="gelu"), 2, 16, None),
    ("top2-sqrelu-8experts", dict(top_k=2, act="sqrelu", n_experts=8), 1, 48,
     None),
    ("drops", dict(top_k=2, capacity_factor=0.25), 2, 32, None),
    ("tied-top1-drops", dict(top_k=1), 2, 16, (1, 3)),
    ("tied-top2-drops", dict(top_k=2, capacity_factor=0.5), 2, 16, (0, 2)),
]


@pytest.mark.parametrize("name,upd,B,S,tie", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
def test_moe_apply_matches_reference(name, upd, B, S, tie, rng, monkeypatch):
    cfg, jcfg = _both("olmoe-1b-7b", **upd)
    params = _moe_params(cfg, rng, tie)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if tie is not None:
        x = np.abs(x)
    y_ref, aux_ref, disp_ref = _ref_moe(jcfg, params, x)
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    y, aux, disp, idx, keep = _port_moe(cfg, p, torch.as_tensor(x),
                                        monkeypatch)
    _close(y, y_ref, "y")
    _close(aux, aux_ref, "aux")
    np.testing.assert_array_equal(disp.numpy(), disp_ref)
    kept, total = int(keep.sum()), keep.numel()
    if "drops" in name:
        assert kept < total, "the case must drop assignments"
    else:
        assert kept == total
    if tie is not None:  # the tied pair leads: the lower index comes first
        assert bool((idx[..., 0] == tie[0]).all())
        if cfg.top_k > 1:
            assert bool((idx[..., 1] == tie[1]).all())


def test_moe_tie_order_is_jax_top_k(rng):
    """``_top_k`` against ``jax.lax.top_k`` on rows full of ties."""
    probs = rng.integers(0, 4, size=(64, 16)).astype(np.float32) / 4.0
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 5)
    v, i = moe._top_k(torch.as_tensor(probs), 5)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_moe_one_hot_past_its_classes_is_zero():
    got = moe._one_hot(torch.tensor([0.0, 3.0, 4.0, 7.0]), 4)
    want = jax.nn.one_hot(jnp.asarray([0.0, 3.0, 4.0, 7.0]), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("B", [3, 4])
def test_moe_batch_groups_matches_reference(B, rng, monkeypatch):
    """A decode-shaped step (S = 1) with ``moe_batch_groups``: the B tokens
    share one group and its own capacity rule (C = 2 at B = 3, 4 at
    B = 4)."""
    cfg, jcfg = _both("olmoe-1b-7b", moe_batch_groups=True)
    params = _moe_params(cfg, rng)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    y_ref, aux_ref, disp_ref = _ref_moe(jcfg, params, x)
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    y, aux, disp, _, _ = _port_moe(cfg, p, torch.as_tensor(x), monkeypatch)
    _close(y, y_ref, "y")
    _close(aux, aux_ref, "aux")
    assert tuple(disp.shape) == disp_ref.shape == (1, 1, B, 4, 2 * (B // 2))
    np.testing.assert_array_equal(disp.numpy(), disp_ref)


def test_moe_capacity_keeps_the_configured_group():
    """A decode step (one token a group) gets ``moe_capacity`` slots an
    expert, from the configured group: 40 at olmoe-1b-7b's settings."""
    cfg, jcfg = get_config("olmoe-1b-7b"), jax_get_config("olmoe-1b-7b")
    assert moe.moe_capacity(cfg) == jax_moe.moe_capacity(jcfg) == 40
    for name in ("olmoe-1b-7b", "llama4-maverick-400b-a17b"):
        assert moe.moe_capacity(smoke_config(name)) == \
            jax_moe.moe_capacity(jax_smoke_config(name))


# ------------------------------------------------------------ the MoE LMs
LM_ARCHS = ["olmoe-1b-7b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("name", LM_ARCHS)
def test_moe_lm_prefill_and_decode_past_cache_match_reference(name, rng):
    cfg, jcfg = _both(name)
    jmodel, jparams, model, params = _carried(cfg, jcfg)
    prompt = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                            cache_len=8)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(prompt)},
                           cache_len=8)
    _close(tl, jl, "prefill logits")
    for key in ("k", "v"):
        _close(tc[key], jc[key], f"prefill {key}")
    for step in range(4):
        tok = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = model.decode_step(params, tc, {"token": torch.as_tensor(tok)})
        _close(tl, jl, f"decode {step} logits")
        for key in ("k", "v"):
            _close(tc[key], jc[key], f"decode {step} {key}")
    assert int(tc["pos"]) == int(jc["pos"]) == 12


def _loss_and_grads(model, params, batch):
    for t in params.values():
        t.requires_grad_(True)
    loss, met = model.loss(params, batch)
    keys = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys])
    return loss, met, dict(zip(keys, grads))


def _check_loss_and_grads(cfg, jcfg, jbatch, batch, remats=("none",)):
    jmodel, jparams, _, _ = _carried(cfg, jcfg, seed=3)
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams,
                                                                 jbatch)
    jh, jaux = jmodel.forward(jparams, jbatch)
    runs = {}
    for remat in remats:
        c = cfg.with_updates(remat=remat)
        params = lm_params_from_numpy(
            c, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
        model = build_model(c)
        with torch.no_grad():
            h, aux = model.forward(params, batch)
        _close(h, jh, "forward hidden")
        _close(aux, jaux, "forward aux")
        loss, met, grads = _loss_and_grads(model, params, batch)
        assert set(met) == set(jm) == {"xent", "aux"}
        _close(loss, jl, "loss")
        for k in ("xent", "aux"):
            _close(met[k], jm[k], k)
        assert set(grads) == set(jg)
        for k, g in grads.items():
            _close(g, jg[k], f"{remat} grad {k}")
        runs[remat] = (float(loss.detach()), grads)
    # checkpointing recomputes the same operations: the same bits
    for remat in remats[1:]:
        assert runs[remat][0] == runs[remats[0]][0]
        for k, g in runs[remat][1].items():
            assert torch.equal(g, runs[remats[0]][1][k]), (remat, k)
    return jm


def _token_batch(cfg, rng, B=2, S=24):
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.9).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts),
             "loss_mask": jnp.asarray(mask)},
            {"tokens": torch.as_tensor(toks), "targets": torch.as_tensor(tgts),
             "loss_mask": torch.as_tensor(mask)})


@pytest.mark.parametrize("name", LM_ARCHS)
def test_moe_lm_forward_loss_and_grads_match_reference(name, rng):
    """``forward`` (hidden and aux), ``loss`` (the total, xent and aux) and
    every parameter's gradient, the aux loss's included, under remat
    "none" and "full" (bit-equal to each other)."""
    cfg, jcfg = _both(name)
    jbatch, batch = _token_batch(cfg, rng)
    jm = _check_loss_and_grads(cfg, jcfg, jbatch, batch, ("none", "full"))
    assert float(jm["aux"]) > 0


@pytest.mark.parametrize("name,kw", [
    ("smoke olmoe-1b-7b", {}), ("smoke llama4-maverick", {}),
    ("full olmoe-1b-7b", {}), ("full llama4-maverick", {}),
    ("smoke olmoe-1b-7b moe_every=2", {"moe_every": 2, "n_layers": 4}),
    ("smoke internvl2-26b", {})])
def test_param_and_active_counts_match_reference(name, kw):
    size, arch = name.split()[:2]
    arch = {"llama4-maverick": "llama4-maverick-400b-a17b"}.get(arch, arch)
    if size == "smoke":
        cfg, jcfg = _both(arch)
    else:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
    if "moe_every" in kw:
        cfg, jcfg = _grouped(cfg, jcfg, **kw)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    assert model.param_count() == jmodel.param_count()
    assert model.active_param_count() == jmodel.active_param_count()
    assert {k: (v.shape, v.init, v.scale)
            for k, v in model.param_specs().items()} == \
        {k: (v.shape, v.init, v.scale)
         for k, v in jmodel.param_specs().items()}
    if name == "full olmoe-1b-7b":
        assert model.param_count() == 6_919_096_320


# ------------------------------------------------------ the grouped layout
@dataclasses.dataclass(frozen=True)
class GroupedConfig(base.ArchConfig):
    moe_every: int = 1


@dataclasses.dataclass(frozen=True)
class JaxGroupedConfig(jax_base.ArchConfig):
    moe_every: int = 1


def _grouped(cfg, jcfg, moe_every=2, **upd):
    def up(c, cls):
        return cls(**{f.name: getattr(c, f.name)
                      for f in dataclasses.fields(c)},
                   moe_every=moe_every).with_updates(**upd)
    return up(cfg, GroupedConfig), up(jcfg, JaxGroupedConfig)


def test_grouped_layout_matches_reference(rng):
    """olmoe's smoke config at 4 layers with ``moe_every=2``: two groups of
    (dense, MoE), the params stacked as ``layers_dense/`` (2 deep) and
    ``layers_moe/`` (2 deep); forward, loss and gradients, prefill and 4
    decode steps, and the cache in depth order (group by group)."""
    cfg, jcfg = _grouped(*_both("olmoe-1b-7b"), n_layers=4)
    model = build_model(cfg)
    assert model.moe_every == 2 and model._layout() == (2, 1)
    assert {k.split("/")[0] for k in model.param_specs()} == {
        "embed", "layers_dense", "layers_moe", "ln_f", "unembed"}
    assert model.param_specs()["layers_moe/moe/wo"].shape[0] == 2
    jbatch, batch = _token_batch(cfg, rng, S=16)
    _check_loss_and_grads(cfg, jcfg, jbatch, batch, ("none", "full"))

    jmodel, jparams, model, params = _carried(cfg, jcfg, seed=1)
    prompt = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                            cache_len=10)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(prompt)},
                           cache_len=10)
    _close(tl, jl, "prefill logits")
    assert tuple(tc["k"].shape) == jc["k"].shape == (4, 2, 10, 4, 16)
    for key in ("k", "v"):
        _close(tc[key], jc[key], f"prefill {key}")
    for step in range(4):  # past the cache at the last two steps
        tok = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = model.decode_step(params, tc, {"token": torch.as_tensor(tok)})
        _close(tl, jl, f"decode {step} logits")
        for key in ("k", "v"):
            _close(tc[key], jc[key], f"decode {step} {key}")
    # the cache's layers are in depth order, as the reference's: the same
    # cache with two layers swapped would not match it
    swapped = tc["k"][[0, 2, 1, 3]]
    assert not np.allclose(swapped.numpy(), np.asarray(jc["k"]), atol=TOL)


def test_grouped_layout_refuses_kv_quant():
    cfg, jcfg = _grouped(*_both("olmoe-1b-7b"), n_layers=4, kv_quant=True)
    with pytest.raises(NotImplementedError, match="grouped"):
        build_model(cfg)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    with pytest.raises(AssertionError, match="grouped"):
        jmodel.prefill(jparams, {"tokens": jnp.zeros((1, 4), jnp.int32)})


# ------------------------------------------------------------ the int8 cache
def test_kv_quantize_rounds_half_to_even():
    """Rows whose largest |x| is 127 have scale 1: every x/scale is x, and
    the .5s round to the even neighbour, as ``jnp.round`` does."""
    row = np.array([127.0, 2.5, 3.5, -0.5, -1.5, 0.5, 126.5, -2.5],
                   np.float32)
    x = np.stack([row, -row, row / 127.0, np.zeros_like(row)])
    q, s = lm.kv_quantize(torch.as_tensor(x))
    jq, js = jax_lm.kv_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy()[0],
                                  [127, 2, 4, 0, -2, 0, 126, -2])
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = lm.kv_dequantize(q, s, dt).float().numpy()
        want = np.asarray(jax_lm.kv_dequantize(jq, js, jdt), np.float32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,cache_len", [("llama3.2-1b", 16),
                                            ("llama3.2-1b", 12),
                                            ("olmoe-1b-7b", 14)])
def test_kv_quant_cache_matches_reference(name, cache_len, rng):
    """Prefill and 4 decode steps with the int8 cache (the last steps past
    the cache when ``cache_len`` is the prompt's length). The prefill's
    int8 K/V and scales are bit-equal to the reference's ``kv_quantize`` of
    the port's own float K/V (the unquantized model's prefill cache, the
    same parameters). Against the reference's caches, whose float K/V come
    from products summed in another order: the scales within 1e-4 of
    themselves, the int8 values equal but where a value sits on a rounding
    boundary (off by one, at most 0.5% of them); logits within 1e-4, each
    decode step run on the reference's cache."""
    cfg, jcfg = _both(name, kv_quant=True)
    jmodel, jparams, model, params = _carried(cfg, jcfg, seed=2)
    prompt = rng.integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                            cache_len=cache_len)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(prompt)},
                           cache_len=cache_len)
    shapes = {k: (tuple(s), d) for k, (s, d) in
              model.cache_shape(2, cache_len).items()}
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == shapes
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == torch.float32
    assert shapes["k_scale"][0] == (cfg.n_layers, 2, cache_len,
                                    cfg.n_kv_heads, 1)
    _, fc = build_model(cfg.with_updates(kv_quant=False)).prefill(
        params, {"tokens": torch.as_tensor(prompt)}, cache_len=cache_len)
    for key in ("k", "v"):  # the prompt's slots (the rest are zero-padded)
        q, s = jax_lm.kv_quantize(jnp.asarray(fc[key][:, :, :12].numpy()))
        np.testing.assert_array_equal(tc[key][:, :, :12].numpy(),
                                      np.asarray(q))
        np.testing.assert_array_equal(tc[f"{key}_scale"][:, :, :12].numpy(),
                                      np.asarray(s))
        assert not tc[f"{key}_scale"][:, :, 12:].any()

    def close(step):
        _close(tl, jl, f"{step} logits")
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       rtol=TOL, err_msg=f"{step} {key}")
        for key in ("k", "v"):
            d = np.abs(tc[key].numpy().astype(int)
                       - np.asarray(jc[key]).astype(int))
            assert d.max() <= 1 and np.count_nonzero(d) <= 0.005 * d.size, \
                (step, key, int(d.max()), np.count_nonzero(d))

    close("prefill")
    for step in range(4):
        # each step from the reference's cache: a value that rounds the
        # other way at one step would otherwise move every later step's
        # logits by a quantization step's effect
        tc = {k: torch.as_tensor(np.asarray(v)) for k, v in jc.items()}
        tok = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = model.decode_step(params, tc, {"token": torch.as_tensor(tok)})
        close(f"decode {step}")
    init = model.init_cache(2, cache_len)
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == shapes


def test_kv_quant_decode_close_to_unquantized(rng):
    """The reference's own check (``tests/test_perf_knobs.py``): 4 greedy
    steps with and without the int8 cache, logits within 2% of their
    scale."""
    cfg = smoke_config("llama3.2-1b")
    m0, m1 = build_model(cfg), build_model(cfg.with_updates(kv_quant=True))
    params = m0.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(rng.integers(2, 100, (2, 12)), dtype=torch.int32)
    l0, c0 = m0.prefill(params, {"tokens": toks}, cache_len=16)
    l1, c1 = m1.prefill(params, {"tokens": toks}, cache_len=16)
    for _ in range(4):
        tok = torch.argmax(l0, -1).to(torch.int32)
        l0, c0 = m0.decode_step(params, c0, {"token": tok})
        l1, c1 = m1.decode_step(params, c1, {"token": tok})
    assert float((l0 - l1).abs().max()) / float(l0.abs().max()) < 0.02


# ---------------------------------------------------------- the vision prefix
def test_vlm_vision_prefix_matches_reference(rng):
    """internvl2's smoke LM with 8 projected vision embeddings before 16
    tokens: forward, loss and gradients (``vision_proj/w``'s included),
    then prefill and 4 decode steps past the cache."""
    cfg, jcfg = _both("internvl2-26b")
    assert "vision_proj/w" in build_model(cfg).param_specs()
    V, T = cfg.vision_tokens, 16
    ve = rng.normal(size=(2, V, cfg.vision_feat_dim)).astype(np.float32)
    jbatch, batch = _token_batch(cfg, rng, S=V + T)
    jbatch["tokens"], batch["tokens"] = jbatch["tokens"][:, :T], \
        batch["tokens"][:, :T]
    jbatch["vision_embeds"], batch["vision_embeds"] = jnp.asarray(ve), \
        torch.as_tensor(ve)
    _check_loss_and_grads(cfg, jcfg, jbatch, batch)

    jmodel, jparams, model, params = _carried(cfg, jcfg, seed=4)
    toks = rng.integers(0, cfg.vocab, size=(2, T)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                      "vision_embeds": jnp.asarray(ve)})
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(toks),
                                    "vision_embeds": torch.as_tensor(ve)})
    assert tc["k"].shape[2] == V + T
    _close(tl, jl, "prefill logits")
    for key in ("k", "v"):
        _close(tc[key], jc[key], f"prefill {key}")
    for step in range(4):
        tok = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = model.decode_step(params, tc, {"token": torch.as_tensor(tok)})
        _close(tl, jl, f"decode {step} logits")
    # without vision_embeds the prefix is left out, as in the reference
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, _ = model.prefill(params, {"tokens": torch.as_tensor(toks)})
    _close(tl, jl, "token-only prefill logits")
