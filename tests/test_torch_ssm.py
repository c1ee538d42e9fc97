"""The port's SSM family (Mamba-2) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its port:

- the SSD scan kernel's plain version (K6, which its wrapper runs for CPU
  tensors), through the port's ``ops.ssd``, against ``repro``'s Pallas
  kernel in interpret mode and its ``ref.py`` (the literal recurrence), at
  the shapes of ``tests/test_kernels.py`` (padded tail included) and with
  the state carried across 8 chunks;
- the port's literal oracle ``kernels/ssd_scan/ref.py::ssd_ref`` against
  ``repro``'s, and against K6's plain version;
- ``ssd_chunked`` (the reference's XLA path) and ``ssd_naive``, the causal
  conv, the softplus, and ``ssd_block_apply`` in prefill and decode;
- the smoke ``MambaLM`` with the JAX params carried across
  (``modeling.convert.lm_params_from_numpy``), under ``attn_impl="xla"`` and
  ``"pallas"`` on the JAX side: prefill logits, state and conv cache, 8
  teacher-forced decode steps, ``forward`` and greedy generation.

Tolerances: the SSD scan at ``tests/test_kernels.py``'s own (5e-5 in float32
and 3e-2 in bf16 between the two kernels; 1e-3 in float32 and 1e-1 / 5e-2 in
bf16 against the recurrence); 1e-4 for LM logits and caches in float32
(summation order differs between XLA and PyTorch matmuls), the dense LM's
tolerance in ``tests/test_torch_modeling.py``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.ssd_scan.kernel import ssd_scan_bhsd as jax_ssd_scan_bhsd
from repro.kernels.ssd_scan.ops import ssd as jax_ssd_pallas
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.modeling import rglru as jax_rglru
from repro.modeling import ssd as jax_ssd
from repro.modeling.registry import build_model as jax_build_model
from repro.serving.engine import generate as jax_generate
from repro_torch import kernels
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bhsd, ssd_scan_plain
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.modeling import ssd as port_ssd
from repro_torch.modeling.convert import lm_params_from_numpy
from repro_torch.modeling.layers import rms_norm
from repro_torch.modeling.mamba import MambaLM
from repro_torch.modeling.module import init_params
from repro_torch.modeling.registry import build_model
from repro_torch.modeling.rglru import causal_conv1d
from repro_torch.serving.engine import generate

ARCH = "mamba2-780m"
KERNEL_TOL = {"float32": 5e-5, "bfloat16": 3e-2}
RECURRENCE_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (1e-1, 5e-2)}
LM_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py's SSD sweep: (b, S, nh, hd, ds, chunk)
SSD_SHAPES = [(1, 32, 2, 8, 4, 8), (2, 64, 4, 16, 16, 16),
              (1, 100, 2, 8, 8, 32)]  # the last pads its tail chunk


def _pair(x: np.ndarray, dtype: str):
    """The same float32 values in both frameworks, rounded to ``dtype``."""
    x = np.asarray(x, np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.as_tensor(x).to(td)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


def _ssd_inputs(rng, b, S, nh, hd, ds, dtype):
    """(jax, torch) pairs of x, dt, A, B, C drawn as tests/test_kernels.py
    draws them."""
    x = _pair(rng.normal(size=(b, S, nh, hd)), dtype)
    dt = _pair(np.abs(rng.normal(size=(b, S, nh))) * 0.5, "float32")
    A = _pair(-np.abs(rng.normal(size=(nh,))) - 0.1, "float32")
    B = _pair(rng.normal(size=(b, S, ds)), dtype)
    C = _pair(rng.normal(size=(b, S, ds)), dtype)
    return tuple(zip(x, dt, A, B, C))  # (jax args, torch args)


# ------------------------------------------------------ K6 plain version
@pytest.mark.parametrize("b,S,nh,hd,ds,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_reference(b, S, nh, hd, ds, chunk, dtype, rng):
    """ops.ssd on CPU tensors (K6's plain version) against the Pallas kernel
    in interpret mode and against the literal recurrence."""
    jargs, targs = _ssd_inputs(rng, b, S, nh, hd, ds, dtype)
    kernels.reset_launch_counts()
    y, st = ssd(*targs, chunk=chunk)
    assert kernels.launch_counts()["ssd_scan"] == 0
    assert y.dtype == targs[0].dtype and tuple(y.shape) == (b, S, nh, hd)
    assert st.dtype == torch.float32 and tuple(st.shape) == (b, nh, hd, ds)
    jy, jst = jax_ssd_pallas(*jargs, chunk=chunk, interpret=True)
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(jy), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(st), _np(jst), atol=tol, rtol=0)
    ry, rst = jax_ssd_ref(*jargs)
    ytol, stol = RECURRENCE_TOL[dtype]
    assert np.max(np.abs(_np(y) - _np(ry))) < ytol
    assert np.max(np.abs(_np(st) - _np(rst))) < stol


def test_ssd_state_carried_across_8_chunks(rng):
    """The final state across 8 chunks equals the Pallas kernel's, the
    recurrence's and the port's own one-chunk state."""
    b, S, nh, hd, ds = 1, 64, 2, 4, 4
    jargs, targs = _ssd_inputs(rng, b, S, nh, hd, ds, "float32")
    y8, st8 = ssd(*targs, chunk=8)
    _, st64 = ssd(*targs, chunk=64)
    jy8, jst8 = jax_ssd_pallas(*jargs, chunk=8, interpret=True)
    _, rst = jax_ssd_ref(*jargs)
    np.testing.assert_allclose(_np(y8), _np(jy8), atol=5e-5, rtol=0)
    np.testing.assert_allclose(_np(st8), _np(jst8), atol=5e-5, rtol=0)
    np.testing.assert_allclose(_np(st8), _np(rst), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(st8), _np(st64), atol=1e-4, rtol=0)


def test_ssd_scan_kernel_layout_matches_pallas_kernel(rng):
    """The kernel-layout wrapper on CPU tensors, with strided views in and
    an ``out`` view, against the Pallas kernel called the same way."""
    b, S, nh, hd, ds, chunk = 2, 48, 3, 8, 16, 16
    jargs, targs = _ssd_inputs(rng, b, S, nh, hd, ds, "float32")
    x, dt, A, B, C = targs
    out = torch.zeros((b, S, nh, hd))
    y, st = ssd_scan_bhsd(x.transpose(1, 2), dt.transpose(1, 2), A, B, C,
                          chunk=chunk, out=out.transpose(1, 2))
    assert y.data_ptr() == out.data_ptr()
    jx, jdt, jA, jB, jC = jargs
    jy, jst = jax_ssd_scan_bhsd(jnp.moveaxis(jx, 2, 1),
                                jnp.moveaxis(jdt, 2, 1), jA, jB, jC,
                                chunk=chunk, interpret=True)
    np.testing.assert_allclose(_np(out), _np(jnp.moveaxis(jy, 1, 2)),
                               atol=5e-5, rtol=0)
    np.testing.assert_allclose(_np(st), _np(jst), atol=5e-5, rtol=0)
    # S not a multiple of the chunk: the plain version pads the tail
    yp, stp = ssd_scan_plain(x.transpose(1, 2)[:, :, :45],
                             dt.transpose(1, 2)[:, :, :45], A, B[:, :45],
                             C[:, :45], chunk=chunk)
    jy, jst = jax_ssd_pallas(jx[:, :45], jdt[:, :45], jA, jB[:, :45],
                             jC[:, :45], chunk=chunk, interpret=True)
    np.testing.assert_allclose(_np(yp.transpose(1, 2)), _np(jy), atol=5e-5,
                               rtol=0)
    np.testing.assert_allclose(_np(stp), _np(jst), atol=5e-5, rtol=0)


# ------------------------------------------------- ssd.py and the block
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(dtype, rng):
    """The XLA path (scores rounded to the input dtype before the product
    with x) with a padded tail chunk, as the reference computes it."""
    jargs, targs = _ssd_inputs(rng, 2, 40, 2, 8, 8, dtype)
    y, st = port_ssd.ssd_chunked(*targs, chunk=16)
    jy, jst = jax_ssd.ssd_chunked(*jargs, chunk=16)
    tol = KERNEL_TOL[dtype]
    assert y.dtype == targs[0].dtype
    np.testing.assert_allclose(_np(y), _np(jy), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(st), _np(jst), atol=tol, rtol=0)


def test_ssd_naive_matches_reference(rng):
    jargs, targs = _ssd_inputs(rng, 2, 24, 2, 8, 8, "float32")
    y, st = port_ssd.ssd_naive(*targs)
    jy, jst = jax_ssd.ssd_naive(*jargs)
    np.testing.assert_allclose(_np(y), _np(jy), atol=5e-5, rtol=0)
    np.testing.assert_allclose(_np(st), _np(jst), atol=5e-5, rtol=0)
    # the chunked paths agree with the oracle, as tests/test_models_math.py
    # holds the reference's
    yc, stc = port_ssd.ssd_chunked(*targs, chunk=8)
    yk, stk = ssd(*targs, chunk=8)
    for a, b in ((yc, y), (stc, st), (yk, y), (stk, st)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-3, atol=1e-3)


# the literal oracle: float32 y within 5e-5 of the JAX recurrence's (the
# same steps, einsum sums in another order); bf16 y within one bf16 ulp of
# max(1, |y|) (both round the same float32 value, which may sit on a
# rounding boundary), the float32 state within 5e-5
REF_TOL = {"float32": 5e-5, "bfloat16": 2.0 ** -7}


@pytest.mark.parametrize("b,S,nh,hd,ds,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ref_matches_reference(b, S, nh, hd, ds, chunk, dtype, rng):
    """``ssd_ref`` against the JAX package's ``ssd_ref`` on the same seeded
    inputs: y in x's dtype, the final state in float32."""
    jargs, targs = _ssd_inputs(rng, b, S, nh, hd, ds, dtype)
    y, st = ssd_ref(*targs)
    jy, jst = jax_ssd_ref(*jargs)
    assert y.dtype == targs[0].dtype and st.dtype == torch.float32
    assert tuple(y.shape) == (b, S, nh, hd) and tuple(st.shape) == (b, nh, hd,
                                                                    ds)
    ya, yj = _np(y), _np(jy)
    err = np.max(np.abs(ya - yj) / np.maximum(np.abs(yj), 1.0))
    assert err <= REF_TOL[dtype], err
    np.testing.assert_allclose(_np(st), _np(jst), atol=5e-5, rtol=0)


@pytest.mark.parametrize("b,S,nh,hd,ds,chunk", SSD_SHAPES)
def test_ssd_ref_is_the_naive_oracle_and_holds_the_plain_kernel(
        b, S, nh, hd, ds, chunk, rng):
    """``ssd_naive`` is ``ssd_ref`` on float32 x (one recurrence, bit for
    bit), and K6's plain version lies within the recurrence tolerance of
    ``ssd_ref``."""
    _, targs = _ssd_inputs(rng, b, S, nh, hd, ds, "float32")
    y, st = ssd_ref(*targs)
    yn, stn = port_ssd.ssd_naive(*targs)
    assert torch.equal(y, yn) and torch.equal(st, stn)
    yp, sp = ssd(*targs, chunk=chunk)
    ytol, stol = RECURRENCE_TOL["float32"]
    assert float((yp - y).abs().max()) < ytol
    assert float((sp - st).abs().max()) < stol


def test_segsum_matches_reference(rng):
    x = rng.normal(size=(2, 7))
    got = port_ssd._segsum(torch.as_tensor(x, dtype=torch.float32))
    want = np.asarray(jax_ssd._segsum(jnp.asarray(x, jnp.float32)))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    live = ~np.isinf(want)
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=1e-6)


def test_causal_conv1d_matches_reference(rng):
    x, w, b = (rng.normal(size=s) for s in ((2, 9, 12), (4, 12), (12,)))
    got = causal_conv1d(*(torch.as_tensor(a, dtype=torch.float32)
                          for a in (x, w, b)))
    want = jax_rglru.causal_conv1d(*(jnp.asarray(a, jnp.float32)
                                     for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_softplus_matches_jax():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; the port's matches it
    within one float32 ulp over [-30, 40] (``F.softplus`` switches to x
    above 20)."""
    x = np.linspace(-30.0, 40.0, 2001, dtype=np.float32)
    got = port_ssd.softplus(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1.2e-7)


def _block_params(cfg, rng):
    """One SSD block's params as numpy: every spec drawn at a small scale,
    ``a_log`` and ``dt_bias`` spread so the heads decay differently."""
    specs = jax_ssd.ssd_block_specs(cfg)
    out = {k: rng.normal(size=s.shape) * 0.3 for k, s in specs.items()}
    out["a_log"] = rng.uniform(-1.0, 1.0, size=specs["a_log"].shape)
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ssd_block_prefill_and_decode_match_reference(impl, rng):
    """The block's prefill (the SSD through K6's plain version) and 3 decode
    steps (in place on the port's side) against the JAX block."""
    cfg = smoke_config(ARCH).with_updates(attn_impl=impl)
    jcfg = jax_smoke_config(ARCH).with_updates(attn_impl=impl)
    p = _block_params(cfg, rng)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    tp = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    jy, jst, jcv = jax_ssd.ssd_block_apply(jcfg, jp, jnp.asarray(x), impl=impl)
    y, st, cv = port_ssd.ssd_block_apply(cfg, tp, torch.as_tensor(x),
                                         impl=impl)
    for a, b in ((y, jy), (st, jst), (cv, jcv)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), atol=LM_TOL, rtol=0)
    st, cv = st.clone(), cv.clone()
    for _ in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jst, jcv = jax_ssd.ssd_block_apply(jcfg, jp, jnp.asarray(xt),
                                               state=jst, conv_state=jcv)
        st_in, cv_in = st, cv
        y, st, cv = port_ssd.ssd_block_apply(cfg, tp, torch.as_tensor(xt),
                                             state=st, conv_state=cv)
        assert st is st_in and cv is cv_in  # updated in place
        for a, b in ((y, jy), (st, jst), (cv, jcv)):
            np.testing.assert_allclose(_np(a), _np(b), atol=LM_TOL, rtol=0)


# ---------------------------------------------------------------- the LM
def _carried(impl="xla", seed=0):
    """The smoke JAX MambaLM and params, and the port's model with the same
    params (carried across by the converter)."""
    cfg = smoke_config(ARCH).with_updates(attn_impl=impl)
    jcfg = jax_smoke_config(ARCH).with_updates(attn_impl=impl)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    params = lm_params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, build_model(cfg), params


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mamba_prefill_and_decode_match_reference(impl, rng):
    """Prefill logits, SSD state and conv cache (the prompt spans 3 chunks
    of 8, the last one padded), then 8 teacher-forced decode steps."""
    jmodel, jparams, model, params = _carried(impl)
    assert isinstance(model, MambaLM)
    cfg = model.cfg
    prompt = rng.integers(0, cfg.vocab, size=(2, 20)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)})
    kernels.reset_launch_counts()
    tl, tc = model.prefill(params, {"tokens": torch.as_tensor(prompt)})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LM_TOL)
    want = model.cache_shape(2, 20)
    for key in ("state", "conv"):
        assert (tuple(tc[key].shape), tc[key].dtype) == want[key]
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=LM_TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 20
    for _ in range(8):
        tok = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(tok)})
        tl, tc2 = model.decode_step(params, tc,
                                    {"token": torch.as_tensor(tok)})
        assert tc2 is tc  # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LM_TOL)
        for key in ("state", "conv"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       atol=LM_TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 28
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mamba_forward_and_generate_match_reference(impl, rng):
    jmodel, jparams, model, params = _carried(impl, seed=1)
    cfg = model.cfg
    toks = rng.integers(0, cfg.vocab, size=(2, 19)).astype(np.int32)
    jh, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    th, aux = model(params, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=LM_TOL)
    assert float(aux) == 0.0
    want = jax_generate(jmodel, jparams, jnp.asarray(toks[:, :8]),
                        max_new_tokens=6, cache_len=8)
    got = generate(model, params, torch.as_tensor(toks[:, :8]),
                   max_new_tokens=6, cache_len=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mamba_prefill_then_decode_matches_forward(rng):
    """Teacher-forced decode reproduces the forward's logits, as
    tests/test_models_math.py holds the reference to (here in float32)."""
    cfg = smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    toks = torch.as_tensor(rng.integers(2, cfg.vocab, size=(1, 16)),
                           dtype=torch.int32)
    h, _ = model(params, {"tokens": toks})
    full = h @ model._unembed(params)
    k = 8
    logits, cache = model.prefill(params, {"tokens": toks[:, :k]})
    np.testing.assert_allclose(logits.numpy(), full[:, k - 1].numpy(),
                               atol=LM_TOL)
    for t in range(k, 16):
        logits, cache = model.decode_step(params, cache,
                                          {"token": toks[:, t]})
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   atol=LM_TOL, err_msg=f"step {t}")


def test_mamba_param_specs_and_count_mirror_reference():
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (smoke_config(ARCH), jax_smoke_config(ARCH))):
        jspecs = jax_build_model(jcfg).param_specs()
        specs = build_model(cfg).param_specs()
        assert {k: (v.shape, v.init, v.scale) for k, v in specs.items()} == \
            {k: (v.shape, v.init, v.scale) for k, v in jspecs.items()}
    assert build_model(get_config(ARCH)).param_count() == 857_403_648


def test_mamba_serving_cast_keeps_float32_params():
    """The norm scales (per layer, final, the mixer's gated norm), a_log and
    dt_bias stay float32, as the reference uses them; the rest is cast to
    ``cfg.dtype``."""
    cfg = smoke_config(ARCH).with_updates(dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        cast=model.serving_cast)
    keep = {"layers/ln/scale", "ln_f/scale", "layers/mixer/norm/scale",
            "layers/mixer/a_log", "layers/mixer/dt_bias"}
    assert keep < set(params)
    for path, t in params.items():
        want = torch.float32 if path in keep else torch.bfloat16
        assert t.dtype == want, path
    masters = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(masters["layers/mixer/in_proj"].to(torch.bfloat16),
                       params["layers/mixer/in_proj"])
    assert torch.equal(masters["layers/mixer/a_log"],
                       params["layers/mixer/a_log"])


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", ["hi_only", "drop_tile", "zero_group"])
@pytest.mark.parametrize("S,chunk", [(32, 32), (100, 32)])
def test_ssd_bf16_limits_see_planted_faults(fault, S, chunk, rng, capsys):
    """``chip_smoke.py``'s bf16 limits on K6's y by its scale (each row
    within SSD_ROW_TOL of its largest |y|, the mean error within
    SSD_MEAN_TOL of the mean |y|), on the CPU with the Pallas kernel in
    interpret mode as the kernel: the port's plain version lies within both
    of it, and a planted fault (scores x from the hi bf16 term alone, a
    dropped diagonal score tile, a zeroed head group) beyond one."""
    smoke = _load_chip_smoke()
    b, nh, hd, ds = 1, 8, 32, 64
    x = rng.normal(size=(b, S, nh, hd))
    dt = np.abs(rng.normal(size=(b, S, nh))) * 0.5
    A = -np.abs(rng.normal(size=(nh,))) - 0.1
    B, C = (rng.normal(size=(b, S, ds)) * ds ** -0.5 for _ in "BC")
    jargs, targs = zip(*(_pair(v, t) for v, t in (
        (x, "bfloat16"), (dt, "float32"), (A, "float32"), (B, "bfloat16"),
        (C, "bfloat16"))))
    jy, _ = jax_ssd_pallas(*jargs, chunk=chunk, interpret=True)
    kernel_y = torch.from_numpy(np.array(_np(jy))).to(torch.bfloat16) \
        .transpose(1, 2)
    y, _ = ssd(*targs, chunk=chunk)
    row, mean = smoke.ssd_y_errs(y.transpose(1, 2), kernel_y)
    assert row <= smoke.SSD_ROW_TOL and mean <= smoke.SSD_MEAN_TOL, (row,
                                                                      mean)
    kx, kdt, kA, kB, kC = targs
    bad = smoke.ssd_planted(kx.transpose(1, 2), kdt.transpose(1, 2), kA, kB,
                            kC, chunk, fault)
    f_row, f_mean = smoke.ssd_y_errs(bad, kernel_y)
    with capsys.disabled():
        print(f"\nK6 bf16 S={S} sound: row {row:.3g} mean {mean:.3g}; "
              f"{fault}: row {f_row:.3g} mean {f_mean:.3g}")
    assert f_row > smoke.SSD_ROW_TOL or f_mean > smoke.SSD_MEAN_TOL


FULL_WIDTH_GAP_TOL = {32: 1e-4, 300: 5e-4}


def test_chunked_ssd_gap_at_full_width_head_shape(capsys):
    """How far the chunked SSD (K6's plain version) lies from the literal
    recurrence at mamba2-780m's head shape (48 heads of 64, state 128,
    chunk 128), on one full-width layer's inputs drawn from seed 0, at the
    serving prompt (S = 32, one chunk) and at S = 300 (3 chunks, the last
    padded). The full-width card-vs-CPU tolerances of ``chip_smoke.py`` rest
    on this gap: 1e-4 at S = 32; at S = 300 the gap is 1.9e-4 in y on this
    CPU, so the tolerance there is 5e-4 (the gap with a 2.6x margin)."""
    cfg = get_config(ARCH).with_updates(n_layers=1, dtype="float32")
    model = MambaLM(cfg)
    g = torch.Generator().manual_seed(0)
    specs = {k: v for k, v in model.param_specs().items()
             if k.startswith("layers/")}
    p = {k[len("layers/"):]: v[0] for k, v in init_params(g, specs).items()}
    d_inner, nh, hd, ds = port_ssd.ssd_dims(cfg)
    for S, tol in FULL_WIDTH_GAP_TOL.items():
        h = rms_norm(torch.randn((1, S, cfg.d_model), generator=g),
                     p["ln/scale"])
        z = h @ p["mixer/in_proj"]
        xbc = torch.nn.functional.silu(causal_conv1d(
            z[..., d_inner:2 * d_inner + 2 * ds], p["mixer/conv/w"],
            p["mixer/conv/b"]))
        args = (xbc[..., :d_inner].reshape(1, S, nh, hd),
                port_ssd.softplus(z[..., 2 * d_inner + 2 * ds:]
                                  + p["mixer/dt_bias"]),
                -torch.exp(p["mixer/a_log"]),
                xbc[..., d_inner:d_inner + ds], xbc[..., d_inner + ds:])
        y, st = ssd(*args, chunk=cfg.ssm_chunk)
        yn, stn = port_ssd.ssd_naive(*args)
        yr, str_ = ssd_ref(*args)
        assert torch.equal(yr, yn) and torch.equal(str_, stn)
        gap = (float((y - yn).abs().max()), float((st - stn).abs().max()))
        with capsys.disabled():
            print(f"\nchunked vs naive SSD at S={S}: y {gap[0]:.3g} (|y| up "
                  f"to {float(yn.abs().max()):.3g}), state {gap[1]:.3g}")
        assert max(gap) < tol, (S, gap)
