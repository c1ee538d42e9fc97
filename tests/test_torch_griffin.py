"""The port's hybrid family (Griffin, recurrentgemma-9b) and the literal
attention oracles against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its port, at ``smoke_config("recurrentgemma-9b")`` (4 layers: one (rec,
rec, attn) group and a rec tail; d_model 64, d_rnn 64, window 16, head_dim
16, MQA, float32):

- the port's literal oracles ``kernels/flash_attention/ref.py::
  attention_ref`` and ``kernels/decode_attention/ref.py::
  decode_attention_ref`` against ``repro``'s, and K4's and K5's plain
  versions (which their wrappers run for CPU tensors) against them;
- ``rglru_scan`` (the reference's associative scan, kept as plain torch)
  and ``rglru_block_apply`` in prefill (the recurrence through K3's plain
  version) and decode (in place), with dense and block-diagonal gates,
  against the JAX block under ``impl="xla"`` and ``"pallas"`` (Pallas in
  interpret mode);
- the smoke ``GriffinLM`` with the JAX params carried across
  (``modeling.convert.lm_params_from_numpy``), under both impls on the JAX
  side: a prefill longer than the window (the ring rolls) and a short one
  into a longer ring, each then 8 teacher-forced decode steps that wrap the
  ring; ``forward``; and the bf16 serving cast.

Tolerances: the oracles at ``tests/test_kernels.py``'s kernel tolerance
(5e-5 in float32; 3e-2 in bf16, a couple of bf16 ulps of the outputs);
1e-4 for the block and the LM in float32 (summation order differs between
XLA and PyTorch matmuls, and between the scans), as for the dense and SSM
families. The bf16 serving model is held to the JAX model in bf16 within
``BF16_LOGIT_TOL`` of the logits' scale and its float32 RG-LRU states within
``BF16_STATE_TOL`` (both round every activation to bf16, in different
orders; measured on the CPU: logits within 0.0073 of their scale, states
within 0.0041, over the prefill and 4 steps).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_attention_ref,
)
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.modeling import rglru as jax_rglru
from repro.modeling.registry import build_model as jax_build_model
from repro_torch import kernels
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.decode_attention.kernel import decode_attention_plain
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_plain
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.linear_scan.kernel import linear_scan_plain
from repro_torch.modeling import rglru as port_rglru
from repro_torch.modeling.convert import lm_params_from_numpy
from repro_torch.modeling.griffin import GriffinLM
from repro_torch.modeling.registry import build_model

ARCH = "recurrentgemma-9b"
KERNEL_TOL = {"float32": 5e-5, "bfloat16": 3e-2}
LM_TOL = 1e-4
BF16_LOGIT_TOL = 2e-2
BF16_STATE_TOL = 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """The same float32 values in both frameworks, rounded to ``dtype``."""
    x = np.asarray(x, np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.as_tensor(x).to(td)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


# ------------------------------------------------------- the K4/K5 oracles
# (B, Sq, Skv, H, Hkv, D, window): Griffin's MQA shapes at smoke width, a
# prefill past its window, a GQA case and a cross-length one
FA_REF_SHAPES = [(1, 24, 24, 4, 1, 16, 16), (2, 12, 12, 4, 1, 16, 0),
                 (2, 20, 20, 8, 2, 32, 6), (1, 8, 24, 4, 2, 16, 0)]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,window", FA_REF_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_reference(B, Sq, Skv, H, Hkv, D, window, dtype,
                                         rng):
    """The port's ``attention_ref`` against ``repro``'s, and K4's plain
    version (the (B, H, S, D) layout) against it."""
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng.normal(size=s), dtype)
        for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    causal = Sq == Skv
    got = attention_ref(q, k, v, causal=causal, window=window)
    want = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Sq, H, D)
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)
    plain = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window).transpose(1, 2)
    np.testing.assert_allclose(_np(plain), _np(got), atol=tol, rtol=0)


def test_attention_ref_gives_mean_of_v_where_no_key_is_visible(rng):
    """Queries past a short key axis under a window of 2 see no key (query
    ``i`` sees key ``j`` when ``i - 2 < j <= i``): the reference's
    ``ref.py`` and the port's give the mean of V there, as the module says;
    the rows that do see keys agree too."""
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((1, 12, 2, 8), (1, 4, 2, 8), (1, 4, 2, 8)))
    got = attention_ref(q, k, v, causal=True, window=2)
    want = jax_attention_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                             causal=True, window=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    mean_v = v.mean(1, keepdim=True).expand(1, 7, 2, 8)
    np.testing.assert_allclose(got[:, 5:].numpy(), mean_v.numpy(), atol=1e-6)


# (B, S, H, Hkv, D, lengths): Griffin's decode at smoke width (a full ring,
# a partly filled one), a GQA case, and a length of 0 (the mean of V)
DEC_REF_CASES = [(1, 16, 4, 1, 16, (16,)), (2, 16, 4, 1, 16, (11, 16)),
                 (3, 24, 8, 2, 32, (24, 1, 7)), (2, 8, 4, 2, 16, (0, 5))]


@pytest.mark.parametrize("B,S,H,Hkv,D,lengths", DEC_REF_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ref_matches_reference(B, S, H, Hkv, D, lengths,
                                                dtype, rng):
    """The port's ``decode_attention_ref`` against ``repro``'s, and K5's
    plain version against it where every row has a valid slot."""
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng.normal(size=s), dtype)
        for s in ((B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lens = np.asarray(lengths, np.int32)
    got = decode_attention_ref(q, k, v, torch.as_tensor(lens))
    want = jax_decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    assert got.dtype == q.dtype and tuple(got.shape) == (B, 1, H, D)
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)
    plain = decode_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), torch.as_tensor(lens))
    rows = lens > 0  # a length of 0 gives 0 in the kernel, mean(V) here
    np.testing.assert_allclose(_np(plain.transpose(1, 2))[rows],
                               _np(got)[rows], atol=tol, rtol=0)


# ------------------------------------------------------------- the RG-LRU
def test_rglru_scan_matches_reference(rng):
    """The plain associative scan against the reference's and against K3's
    plain version (the sequential fold)."""
    x = rng.normal(size=(2, 37, 8)).astype(np.float32)
    a = rng.uniform(0.05, 1.0, size=(2, 37, 8)).astype(np.float32)
    got = port_rglru.rglru_scan(torch.as_tensor(x), torch.as_tensor(a))
    want = jax_rglru.rglru_scan(jnp.asarray(x), jnp.asarray(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    seq, _ = linear_scan_plain(torch.as_tensor(x), torch.as_tensor(a))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=1e-5, rtol=0)


def _block_params(cfg, rng):
    """One RG-LRU block's params as numpy, every spec drawn at a small
    scale, ``lambda`` spread so the channels decay differently."""
    specs = jax_rglru.rglru_block_specs(cfg)
    out = {k: rng.normal(size=s.shape) * 0.3 for k, s in specs.items()}
    out["lambda"] = rng.uniform(-2.0, 2.0, size=specs["lambda"].shape)
    return out


@pytest.mark.parametrize("gates", [0, 4], ids=["dense", "block"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_rglru_block_prefill_and_decode_match_reference(impl, gates, rng):
    """The block's prefill (the recurrence through K3's plain version, no
    launch) and 3 decode steps (in place on the port's side) against the
    JAX block, with dense and block-diagonal gates."""
    cfg = smoke_config(ARCH).with_updates(attn_impl=impl,
                                          rglru_block_gates=gates)
    jcfg = jax_smoke_config(ARCH).with_updates(attn_impl=impl,
                                               rglru_block_gates=gates)
    p = _block_params(cfg, rng)
    if gates:
        assert p["gate_a/w"].shape == (4, 16, 16)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    tp = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    jy, jst, jcv = jax_rglru.rglru_block_apply(jcfg, jp, jnp.asarray(x),
                                               impl=impl)
    kernels.reset_launch_counts()
    y, st, cv = port_rglru.rglru_block_apply(cfg, tp, torch.as_tensor(x),
                                             impl=impl)
    assert kernels.launch_counts()["linear_scan"] == 0
    for a, b in ((y, jy), (st, jst), (cv, jcv)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), atol=LM_TOL, rtol=0)
    assert st.dtype == torch.float32
    st, cv = st.clone(), cv.clone()
    for _ in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jst, jcv = jax_rglru.rglru_block_apply(
            jcfg, jp, jnp.asarray(xt), state=jst, conv_state=jcv, impl=impl)
        st_in, cv_in = st, cv
        y, st, cv = port_rglru.rglru_block_apply(
            cfg, tp, torch.as_tensor(xt), state=st, conv_state=cv, impl=impl)
        assert st is st_in and cv is cv_in  # updated in place
        for a, b in ((y, jy), (st, jst), (cv, jcv)):
            np.testing.assert_allclose(_np(a), _np(b), atol=LM_TOL, rtol=0)


def test_rglru_short_prompt_pads_the_conv_state(rng):
    """A prompt shorter than the conv window leaves a left-padded conv
    state, as the reference's."""
    cfg = smoke_config(ARCH)
    p = _block_params(cfg, rng)
    x = rng.normal(size=(1, 2, cfg.d_model)).astype(np.float32)
    _, _, jcv = jax_rglru.rglru_block_apply(
        jax_smoke_config(ARCH), {k: jnp.asarray(v, jnp.float32)
                                 for k, v in p.items()}, jnp.asarray(x))
    _, _, cv = port_rglru.rglru_block_apply(
        cfg, {k: torch.as_tensor(v, dtype=torch.float32)
              for k, v in p.items()}, torch.as_tensor(x))
    assert tuple(cv.shape) == jcv.shape == (1, 3, cfg.d_rnn)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), atol=LM_TOL)


# ---------------------------------------------------------------- the LM
def _carried(impl="xla", seed=0):
    """The smoke JAX GriffinLM and params, and the port's model with the
    same params (carried across by the converter)."""
    cfg = smoke_config(ARCH).with_updates(attn_impl=impl)
    jcfg = jax_smoke_config(ARCH).with_updates(attn_impl=impl)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    params = lm_params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, build_model(cfg), params


CACHE_KEYS = ("state", "conv", "k", "v")


def _assert_cache(tc, jc):
    for key in CACHE_KEYS:
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), atol=LM_TOL,
                                   err_msg=key)


# (prompt length, cache_len): a prompt of 28 past the 16-slot window (the
# ring keeps the last 16 positions, rolled by 12; decode positions 28-35
# write slots 12-15, then wrap to 0-3), and a prompt of 10 into a 16-slot
# ring (zero-padded; decode positions 10-17 fill it and wrap to 0-1)
RING_CASES = [(28, None), (10, 16)]


@pytest.mark.parametrize("S,cache_len", RING_CASES,
                         ids=["past-window", "padded-ring"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_griffin_prefill_and_decode_match_reference(impl, S, cache_len, rng):
    """Prefill logits and cache (RG-LRU states and conv windows, the K/V
    rings), then 8 teacher-forced decode steps that wrap the ring, each
    step's logits and cache within 1e-4 of the JAX model's."""
    jmodel, jparams, model, params = _carried(impl)
    assert isinstance(model, GriffinLM)
    cfg = model.cfg
    prompt = rng.integers(0, cfg.vocab, size=(2, S)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                            cache_len=cache_len)
    kernels.reset_launch_counts()
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(prompt)},
                           cache_len=cache_len)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LM_TOL)
    want = model.cache_shape(2, cache_len or S)
    for key in CACHE_KEYS:
        assert (tuple(tc[key].shape), tc[key].dtype) == want[key]
    assert tc["k"].shape[2] == cfg.attn_window
    _assert_cache(tc, jc)
    assert int(tc["pos"]) == int(jc["pos"]) == S
    for _ in range(8):
        tok = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc2 = model.decode_step(params, tc,
                                    {"token": torch.as_tensor(tok)})
        assert tc2 is tc  # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LM_TOL)
        _assert_cache(tc, jc)
    assert int(tc["pos"]) == int(jc["pos"]) == S + 8
    assert (S + 7) % cfg.attn_window < S % cfg.attn_window  # it wrapped
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_griffin_forward_matches_reference(impl, rng):
    jmodel, jparams, model, params = _carried(impl, seed=1)
    cfg = model.cfg
    toks = rng.integers(0, cfg.vocab, size=(2, 27)).astype(np.int32)
    jh, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    th, aux = model(params, {"tokens": torch.as_tensor(toks)})
    assert tuple(th.shape) == (2, 27, cfg.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=LM_TOL)
    assert float(aux) == 0.0


def test_griffin_prefill_then_decode_matches_forward(rng):
    """Teacher-forced decode through the ring reproduces the forward's
    logits past the window."""
    cfg = smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    toks = torch.as_tensor(rng.integers(2, cfg.vocab, size=(1, 40)),
                           dtype=torch.int32)
    h, _ = model(params, {"tokens": toks})
    full = h @ model._unembed(params)
    k = 20
    logits, cache = model.prefill(params, {"tokens": toks[:, :k]})
    np.testing.assert_allclose(logits.numpy(), full[:, k - 1].numpy(),
                               atol=LM_TOL)
    for t in range(k, 40):
        logits, cache = model.decode_step(params, cache,
                                          {"token": toks[:, t]})
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   atol=LM_TOL, err_msg=f"step {t}")


def test_griffin_serving_cast_keeps_float32_params():
    """The norm scales and the RG-LRU's gate weights, gate biases and
    ``lambda`` stay float32 (the reference never casts them); the rest is
    cast to ``cfg.dtype``."""
    cfg = smoke_config(ARCH).with_updates(dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        cast=model.serving_cast)
    keep = {"ln_f/scale", "rec_layers/ln_mix/scale",
            "rec_layers/ln_mlp/scale", "attn_layers/ln_mix/scale",
            "attn_layers/ln_mlp/scale", "rec_layers/mixer/gate_a/w",
            "rec_layers/mixer/gate_a/b", "rec_layers/mixer/gate_x/w",
            "rec_layers/mixer/gate_x/b", "rec_layers/mixer/lambda"}
    assert keep < set(params)
    for path, t in params.items():
        want = torch.float32 if path in keep else torch.bfloat16
        assert t.dtype == want, path
    masters = model.init(torch.Generator().manual_seed(0))
    for path in ("rec_layers/mixer/wx", "rec_layers/mixer/conv/b",
                 "attn_layers/attn/q"):
        assert torch.equal(masters[path].to(torch.bfloat16), params[path])
    assert torch.equal(masters["rec_layers/mixer/gate_a/w"],
                       params["rec_layers/mixer/gate_a/w"])


def test_griffin_bf16_serving_cast_matches_reference(rng):
    """The bf16 model on the serving cast (float32 gates, lambda and norms)
    against the JAX model in bf16 on its float32 params: prefill past the
    window and 4 decode steps, logits within ``BF16_LOGIT_TOL`` of their
    scale, the float32 RG-LRU states within ``BF16_STATE_TOL``."""
    cfg = smoke_config(ARCH).with_updates(dtype="bfloat16")
    jcfg = jax_smoke_config(ARCH).with_updates(dtype="bfloat16")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(2))
    model = build_model(cfg)
    masters = lm_params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()})
    params = {k: model.serving_cast(k, v) for k, v in masters.items()}
    prompt = rng.integers(0, cfg.vocab, size=(1, 20)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)})
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(prompt)})
    assert tc["k"].dtype == tc["conv"].dtype == torch.bfloat16
    assert tc["state"].dtype == torch.float32
    for step in range(5):
        scale = float(np.abs(np.asarray(jl)).max())
        err = float(np.abs(tl.numpy() - np.asarray(jl)).max())
        assert err <= BF16_LOGIT_TOL * max(scale, 1.0), (step, err, scale)
        np.testing.assert_allclose(_np(tc["state"]), _np(jc["state"]),
                                   atol=BF16_STATE_TOL)
        tok = rng.integers(0, cfg.vocab, size=1).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = model.decode_step(params, tc, {"token": torch.as_tensor(tok)})


def test_griffin_param_specs_and_count_mirror_reference():
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (smoke_config(ARCH), jax_smoke_config(ARCH)),
                      (smoke_config(ARCH).with_updates(rglru_block_gates=4),
                       jax_smoke_config(ARCH).with_updates(
                           rglru_block_gates=4))):
        jspecs = jax_build_model(jcfg).param_specs()
        specs = build_model(cfg).param_specs()
        assert {k: (v.shape, v.init, v.scale) for k, v in specs.items()} == \
            {k: (v.shape, v.init, v.scale) for k, v in jspecs.items()}
    assert build_model(get_config(ARCH)).param_count() == 10_444_984_320


def test_griffin_loss_matches_reference(rng):
    """``GriffinLM.loss`` (once a ``NotImplementedError``) against the JAX
    model's: the value and every parameter's gradient within 1e-4, on a
    prompt past the window (``tests/test_torch_training.py`` holds every
    family's loss under both remat settings)."""
    jmodel, jparams, model, params = _carried(seed=2)
    cfg = model.cfg
    toks = rng.integers(0, cfg.vocab, size=(2, 21)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab, size=(2, 21)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
    for t in params.values():
        t.requires_grad_(True)
    loss, met = model.loss(params, {"tokens": torch.as_tensor(toks),
                                    "targets": torch.as_tensor(tgts)})
    keys = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys])
    assert set(met) == set(jm) == {"xent"}
    np.testing.assert_allclose(float(loss), float(jl), rtol=LM_TOL)
    for k, g in zip(keys, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), atol=LM_TOL,
                                   err_msg=k)
