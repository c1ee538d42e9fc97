"""The port's model zoo against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its port:

- ``rms_norm``, ``layer_norm``, ``apply_rope`` and the activations against
  ``repro.modeling.layers``;
- the plain versions of the flash-attention (K4) and flash-decode (K5)
  kernels, which their wrappers run for CPU tensors, against ``repro``'s
  ``ref.py``, its Pallas kernels in interpret mode and its XLA path, over
  the shapes of ``tests/test_kernels.py`` plus decode lengths above S;
- the dense LM with the JAX params carried across
  (``modeling.convert.lm_params_from_numpy``), under ``attn_impl="xla"`` and
  ``"pallas"``: prefill logits and cache, then decode steps past
  ``cache_len`` (the reference's clamped write), and greedy generation.

Tolerances: 5e-5 in float32 and 3e-2 in bf16 for the attention kernels (the
reference's kernel tolerances); 1e-4 for LM logits and caches in float32
(summation order differs between XLA and PyTorch matmuls).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.decode_attention.ops import decode_attention as jax_decode_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.modeling import attention as jax_attention
from repro.modeling import layers as jax_layers
from repro.modeling.registry import build_model as jax_build_model
from repro.serving.engine import generate as jax_generate
from repro_torch import kernels
from repro_torch.configs import ARCHS, ArchConfig, get_config, smoke_config
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.modeling import layers
from repro_torch.modeling.convert import lm_params_from_numpy
from repro_torch.modeling.lm import LM
from repro_torch.modeling.module import ParamSpec, init_params
from repro_torch.modeling.registry import build_model
from repro_torch.serving.engine import generate

JBF16 = jnp.bfloat16
TOL = {"float32": 5e-5, "bfloat16": 3e-2}
LM_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (JBF16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """The same float32 values in both frameworks, rounded to ``dtype``."""
    x = np.asarray(x, np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.as_tensor(x).to(td)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(rng, dtype):
    x = rng.normal(size=(2, 5, 48)) * 3.0
    scale = rng.normal(size=48) * 0.1
    bias = rng.normal(size=48) * 0.1
    jx, tx = _pair(x, dtype)
    js, ts = _pair(scale, "float32")
    jb, tb = _pair(bias, "float32")
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(layers.rms_norm(tx, ts)),
                               _np(jax_layers.rms_norm(jx, js)), atol=tol)
    np.testing.assert_allclose(_np(layers.layer_norm(tx, ts, tb)),
                               _np(jax_layers.layer_norm(jx, js, jb)), atol=tol)
    np.testing.assert_allclose(_np(layers.np_layer_norm(tx)),
                               _np(jax_layers.np_layer_norm(jx)), atol=tol)
    assert layers.rms_norm(tx, ts).dtype == tx.dtype


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(rng, theta, dtype):
    x = rng.normal(size=(2, 7, 3, 16))
    pos = rng.integers(0, 4000, size=(2, 7))
    jx, tx = _pair(x, dtype)
    np.testing.assert_array_equal(layers.rope_frequencies(16, theta),
                                  jax_layers.rope_frequencies(16, theta))
    got = layers.apply_rope(tx, torch.as_tensor(pos), theta)
    want = jax_layers.apply_rope(jx, jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])
    assert got.dtype == tx.dtype


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "sqrelu", "gelu"])
def test_activations_match_reference(rng, kind):
    x = rng.normal(size=(3, 11)) * 2.0
    g = rng.normal(size=(3, 11))
    jx, tx = _pair(x, "float32")
    jg, tg = _pair(g, "float32")
    np.testing.assert_allclose(_np(layers.activation(kind, tx, tg)),
                               _np(jax_layers.activation(kind, jx, jg)),
                               atol=5e-6)
    assert layers.is_gated(kind) == jax_layers.is_gated(kind)


# ------------------------------------------------------ K4 plain version
FA_SHAPES = [(1, 64, 2, 1, 32), (2, 128, 4, 2, 64), (1, 96, 4, 4, 16),
             (1, 256, 8, 1, 128)]


@pytest.mark.parametrize("B,S,H,Hkv,D", FA_SHAPES)
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference(B, S, H, Hkv, D, window,
                                                 dtype, rng):
    """K4's plain version against ``ref.py``, the Pallas kernel in interpret
    mode and the XLA chunked path of ``repro.modeling.attention``."""
    jq, tq = _pair(rng.normal(size=(B, S, H, D)), dtype)
    jk, tk = _pair(rng.normal(size=(B, S, Hkv, D)), dtype)
    jv, tv = _pair(rng.normal(size=(B, S, Hkv, D)), dtype)
    kernels.reset_launch_counts()
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert kernels.launch_counts()["flash_attention"] == 0
    tol = TOL[dtype]
    ref = jax_attention_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol)
    pallas = jax_flash_pallas(jq, jk, jv, causal=True, window=window,
                              block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol)
    xla = jax_attention.attention(jq, jk, jv, causal=True, window=window,
                                  q_chunk=32, impl="xla")
    np.testing.assert_allclose(_np(got), _np(xla), atol=tol)


def test_flash_attention_plain_bidirectional(rng):
    jq, tq = _pair(rng.normal(size=(2, 64, 4, 32)), "float32")
    jk, tk = _pair(rng.normal(size=(2, 48, 2, 32)), "float32")
    jv, tv = _pair(rng.normal(size=(2, 48, 2, 32)), "float32")
    got = flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(
        _np(got), _np(jax_attention_ref(jq, jk, jv, causal=False)),
        atol=TOL["float32"])


# ------------------------------------------------------ K5 plain version
DEC_SHAPES = [(2, 128, 4, 1, 32), (3, 200, 8, 2, 64), (1, 64, 4, 4, 128)]


@pytest.mark.parametrize("B,S,H,Hkv,D", DEC_SHAPES)
@pytest.mark.parametrize("past", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_reference(B, S, H, Hkv, D, past,
                                                  dtype, rng):
    """K5's plain version against ``ref.py``, the Pallas kernel in interpret
    mode and the XLA decode path. ``past`` gives every row a length above S,
    as the serving executor's decode past its cache does (every slot valid);
    the Pallas comparison then runs only where its wrapper pads nothing (it
    would count padded zero slots as valid)."""
    jq, tq = _pair(rng.normal(size=(B, 1, H, D)), dtype)
    jk, tk = _pair(rng.normal(size=(B, S, Hkv, D)), dtype)
    jv, tv = _pair(rng.normal(size=(B, S, Hkv, D)), dtype)
    lengths = (S + 1 + rng.integers(0, 5, size=B)) if past \
        else rng.integers(1, S + 1, size=B)
    lengths = lengths.astype(np.int32)
    kernels.reset_launch_counts()
    got = decode_attention(tq, tk, tv, torch.as_tensor(lengths))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert kernels.launch_counts()["decode_attention"] == 0
    tol = TOL[dtype]
    jl = jnp.asarray(lengths)
    np.testing.assert_allclose(_np(got), _np(jax_decode_ref(jq, jk, jv, jl)),
                               atol=tol)
    xla = jax_attention.decode_attention(jq, jk, jv, jl, impl="xla")
    np.testing.assert_allclose(_np(got), _np(xla), atol=tol)
    if not past or S % 64 == 0:
        pallas = jax_decode_pallas(jq, jk, jv, jl, block_k=64)
        np.testing.assert_allclose(_np(got), _np(pallas), atol=tol)


def test_decode_attention_zero_length_gives_zero(rng):
    """A length-0 row gives 0, as the TPU kernel does (the reference's
    ref.py would give the mean of V there)."""
    q = torch.as_tensor(rng.normal(size=(2, 1, 4, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(2, 32, 2, 16)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(2, 32, 2, 16)), dtype=torch.float32)
    out = decode_attention(q, k, v, torch.tensor([0, 5], dtype=torch.int32))
    assert not out[0].any()
    jout = jax_decode_pallas(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                             jnp.asarray(v.numpy()),
                             jnp.asarray([0, 5], jnp.int32), block_k=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-5)


# ---------------------------------------------------------------- the LM
def _carried(cfg, jcfg, seed=0):
    """The JAX model and params, and the port's model with the same params."""
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    params = lm_params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, build_model(cfg), params


def _both(name, **kw):
    return (smoke_config(name).with_updates(**kw),
            jax_smoke_config(name).with_updates(**kw))


LM_CASES = [("llama3.2-1b", "xla", {}), ("llama3.2-1b", "pallas", {}),
            ("gemma-2b", "xla", {}), ("olmo-1b", "xla", {}),
            ("nemotron-4-340b", "xla", {}),
            ("llama3.2-1b", "xla", {"attn_window": 6})]


@pytest.mark.parametrize("name,impl,extra", LM_CASES,
                         ids=[f"{n}-{i}{'-window' if e else ''}"
                              for n, i, e in LM_CASES])
def test_lm_prefill_and_decode_past_cache_match_reference(name, impl, extra,
                                                          rng):
    """Prefill logits and cache, then 4 decode steps past ``cache_len``: the
    reference clamps each step's write into the last slot and keeps every
    slot valid; the port must do the same (logits and caches within 1e-4).
    The windowed case runs the ring-buffer cache instead."""
    cfg, jcfg = _both(name, attn_impl=impl, **extra)
    jmodel, jparams, model, params = _carried(cfg, jcfg)
    prompt = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                            cache_len=8)
    kernels.reset_launch_counts()
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(prompt)},
                           cache_len=8)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LM_TOL)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=LM_TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 8
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc = model.decode_step(params, tc, {"token": torch.as_tensor(tok)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LM_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       atol=LM_TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 12
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lm_greedy_generate_matches_reference(impl, rng):
    cfg, jcfg = _both("llama3.2-1b", attn_impl=impl)
    jmodel, jparams, model, params = _carried(cfg, jcfg, seed=3)
    prompt = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    want = jax_generate(jmodel, jparams, jnp.asarray(prompt),
                        max_new_tokens=6, cache_len=8)
    got = generate(model, params, torch.as_tensor(prompt), max_new_tokens=6,
                   cache_len=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_forward_and_padded_cache_match_reference(rng):
    cfg, jcfg = _both("llama3.2-1b")
    jmodel, jparams, model, params = _carried(cfg, jcfg, seed=1)
    toks = rng.integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    jh, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    th, aux = model(params, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=LM_TOL)
    assert float(aux) == 0.0
    # a cache longer than the prompt is zero-padded, as in the reference
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            cache_len=20)
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(toks)},
                           cache_len=20)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=LM_TOL)
    tok = toks[:, 0]
    jl, _ = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(tok)})
    tl, _ = model.decode_step(params, tc, {"token": torch.as_tensor(tok)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LM_TOL)


# ------------------------------------------------ params, configs, registry
def test_configs_mirror_reference():
    for name in ARCHS:
        assert get_config(name).__dict__ == jax_get_config(name).__dict__
        assert smoke_config(name).__dict__ == jax_smoke_config(name).__dict__


def test_param_specs_and_count_mirror_reference():
    full = [(get_config(n), jax_get_config(n)) for n in
            ("llama3.2-1b", "olmoe-1b-7b", "llama4-maverick-400b-a17b",
             "internvl2-26b")]
    for cfg, jcfg in (*full, _both("gemma-2b"), _both("nemotron-4-340b"),
                      _both("olmoe-1b-7b"), _both("internvl2-26b")):
        jspecs = jax_build_model(jcfg).param_specs()
        specs = build_model(cfg).param_specs()
        assert {k: (v.shape, v.init, v.scale) for k, v in specs.items()} == \
            {k: (v.shape, v.init, v.scale) for k, v in jspecs.items()}
    assert build_model(get_config("llama3.2-1b")).param_count() == 1_498_482_688
    assert build_model(get_config("olmoe-1b-7b")).param_count() == 6_919_096_320


def test_init_params_is_seeded_and_shaped():
    specs = {"a/w": ParamSpec((64, 32), ("embed", "mlp")),
             "b/scale": ParamSpec((32,), ("embed",), init="zeros"),
             "c/scale": ParamSpec((32,), ("embed",), init="ones"),
             "e/w": ParamSpec((100, 8), ("vocab", "embed"), init="embed",
                              scale=0.5)}

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return init_params(g, specs)

    p, q, r = draw(0), draw(0), draw(1)
    assert all(torch.equal(p[k], q[k]) for k in specs)
    assert not torch.equal(p["a/w"], r["a/w"])
    bound = 2.0 / np.sqrt(64)
    assert float(p["a/w"].abs().max()) <= bound + 1e-7
    assert abs(float(p["a/w"].std()) * np.sqrt(64) - 0.88) < 0.1
    assert not p["b/scale"].any() and bool((p["c/scale"] == 1).all())
    assert abs(float(p["e/w"].std()) - 0.5) < 0.1


@pytest.mark.parametrize("name", ["llama3.2-1b", "olmoe-1b-7b",
                                  "llama4-maverick-400b-a17b",
                                  "internvl2-26b"])
def test_serving_cast_keeps_norms_float32(name):
    """A bf16 executor's parameters: norms and the MoE router's weights
    float32 (the reference uses them so: it never casts ``router/w``),
    every other matrix bf16."""
    cfg = smoke_config(name).with_updates(dtype="bfloat16")
    model = LM(cfg)
    g = torch.Generator()
    g.manual_seed(0)
    params = model.init(g, cast=model.serving_cast)
    for path, t in params.items():
        f32 = "/ln_" in "/" + path or path.endswith("/moe/router/w")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), path
    assert any(p.endswith("moe/router/w") for p in params) == \
        bool(cfg.n_experts)
    masters = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(masters["embed/w"].to(torch.bfloat16),
                       params["embed/w"])


def test_converter_rejects_mismatched_params():
    cfg = smoke_config("llama3.2-1b")
    specs = build_model(cfg).param_specs()
    arrays = {k: np.zeros(v.shape, np.float32) for k, v in specs.items()}
    assert set(lm_params_from_numpy(cfg, arrays)) == set(specs)
    with pytest.raises(KeyError):
        lm_params_from_numpy(cfg, {k: v for k, v in arrays.items()
                                   if k != "embed/w"})
    arrays["embed/w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        lm_params_from_numpy(cfg, arrays)


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_audio_family_builds_encoder(size):
    """The audio family is ported: ``build_model`` returns the port's
    ``AudioEncoder`` for hubert-xlarge (its parity with the reference is
    held in ``tests/test_torch_encoder.py``)."""
    from repro_torch.modeling.encoder import AudioEncoder

    cfg = (get_config if size == "full" else smoke_config)("hubert-xlarge")
    assert type(build_model(cfg)) is AudioEncoder


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_family_builds(name):
    """No family of the registry is refused any more, and each builds the
    reference's parameters: every spec's path, shape, init and scale, and
    the parameter count, at full and smoke size."""
    for cfg, jcfg in ((get_config(name), jax_get_config(name)),
                      (smoke_config(name), jax_smoke_config(name))):
        model, jmodel = build_model(cfg), jax_build_model(jcfg)
        assert {k: (v.shape, v.init, v.scale)
                for k, v in model.param_specs().items()} == \
            {k: (v.shape, v.init, v.scale)
             for k, v in jmodel.param_specs().items()}
        assert model.param_count() == jmodel.param_count() > 0


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "internvl2-26b",
                                  "llama4-maverick-400b-a17b"])
def test_decoder_families_build_lm(name):
    """The MoE and VLM families are the decoder ``LM`` (their parity with
    the reference is held in ``tests/test_torch_moe.py``)."""
    for cfg in (get_config(name), smoke_config(name)):
        assert type(build_model(cfg)) is LM


def test_hybrid_family_builds_griffin():
    """The hybrid family is ported: ``build_model`` returns a ``GriffinLM``
    for recurrentgemma-9b (its parity with the reference is held in
    ``tests/test_torch_griffin.py``)."""
    from repro_torch.modeling.griffin import GriffinLM

    assert isinstance(build_model(get_config("recurrentgemma-9b")), GriffinLM)
    assert isinstance(build_model(smoke_config("recurrentgemma-9b")),
                      GriffinLM)


@dataclasses.dataclass(frozen=True)
class _GroupedConfig(ArchConfig):
    moe_every: int = 1  # read by LM with getattr, as the reference reads it


def test_lm_raises_for_unported_options():
    """The grouped ``moe_every`` layout with the int8 KV cache is refused,
    as the reference's assert refuses it; either alone builds."""
    cfg = smoke_config("olmoe-1b-7b").with_updates(n_layers=4)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    grouped = _GroupedConfig(**fields, moe_every=2)
    assert LM(grouped)._layout() == (2, 1)
    assert LM(cfg.with_updates(kv_quant=True))._layout() == (4, 0)
    with pytest.raises(NotImplementedError, match="grouped"):
        LM(grouped.with_updates(kv_quant=True))
