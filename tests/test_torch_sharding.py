"""The port's sharding layer (``repro_torch.distributed.sharding``) and the
model code it annotates, held against the JAX package's.

- ``make_rules`` equals the reference's for all ten archs on the two
  production mesh shapes, with ``fsdp`` and ``serving`` each on and off,
  read from a dict mesh and from a ``DeviceMesh`` on the fake process
  group; the serving-2D rules of llama4-maverick;
- ``spec_for`` over every ``param_specs`` path and ``cache_axes`` entry,
  and ``param_axes``, equal the reference's; every resolved rule divides
  its tensor dims (the reference's property test);
- ``abstract_params`` matches the reference's shapes and dtypes on ``meta``,
  and counts the two largest archs at full size without allocating;
- ``Sharding``: DTensor placements and per-device shapes, a dim split over
  two mesh axes included;
- ``shard`` returns its input object outside a context, checks
  divisibility inside one, redistributes a DTensor and returns a plain
  tensor as it is; a kernel refuses a DTensor;
- ``cp_chunked_attention`` within 2e-5 of the reference's, with and without
  a window, its gradients within rtol 1e-4 / atol 1e-5; a smoke LM with
  ``cp_attn`` (and ``sp_acts``) under a fake ``model: 4`` context gives the
  loss it gives without one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.distributed import sharding as jsh
from repro.modeling import module as jmodule
from repro.modeling.attention import cp_chunked_attention as j_cp
from repro.modeling.registry import build_model as j_build
from repro_torch import configs as tcfgs
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import destroy_group, make_production_mesh
from repro_torch.modeling import module as tmodule
from repro_torch.modeling.attention import cp_chunked_attention
from repro_torch.modeling.registry import build_model as t_build


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}
ARCHS = sorted(jcfgs.ARCHS)
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture
def fake_meshes():
    """The two production meshes on the fake process group, torn down
    after the test (other test files in this worker must not see it)."""
    try:
        yield {"pod": make_production_mesh(),
               "multipod": make_production_mesh(multi_pod=True)}
    finally:
        destroy_group()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_specs_and_axes_match_reference(arch, mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jm, tm = j_build(jcfg), t_build(tcfg)
    jspecs, tspecs = jm.param_specs(), tm.param_specs()
    assert tmodule.param_axes(tspecs) == jmodule.param_axes(jspecs)
    jcache = jm.cache_axes() if jcfg.family != "audio" else None
    tcache = tm.cache_axes() if tcfg.family != "audio" else None
    assert tcache == jcache
    for fsdp, serving in FLAGS:
        rules = tsh.make_rules(tcfg, mesh, fsdp=fsdp, serving=serving)
        assert rules == jsh.make_rules(jcfg, mesh, fsdp=fsdp,
                                       serving=serving), (fsdp, serving)
        for path, s in tspecs.items():
            assert tsh.spec_for(s.axes, rules) == \
                tuple(jsh.spec_for(jspecs[path].axes, rules)), path
        for name, axes in (tcache or {}).items():
            assert tsh.spec_for(axes, rules) == \
                tuple(jsh.spec_for(axes, rules)), name


def test_rules_read_a_device_mesh(fake_meshes):
    for name, mesh in fake_meshes.items():
        assert tsh.mesh_sizes(mesh) == MESHES[name]
        for arch in ("gemma-2b", "llama4-maverick-400b-a17b", "mamba2-780m"):
            cfg = tcfgs.get_config(arch)
            assert tsh.make_rules(cfg, mesh, fsdp=True) == \
                tsh.make_rules(cfg, FakeMesh(MESHES[name]), fsdp=True)


def test_serving_2d_rules():
    mesh = FakeMesh({"data": 16, "model": 16})
    cfg = tcfgs.get_config("llama4-maverick-400b-a17b").with_updates(
        serve_2d_ffn=True)
    r_train = tsh.make_rules(cfg, mesh, serving=False)
    r_serve = tsh.make_rules(cfg, mesh, serving=True)
    assert r_train["expert_mlp"] is None
    assert r_serve["expert_mlp"] == ("data",)
    assert r_serve["mlp"] == ("model", "data")
    jcfg = jcfgs.get_config("llama4-maverick-400b-a17b").with_updates(
        serve_2d_ffn=True)
    assert r_serve == jsh.make_rules(jcfg, mesh, serving=True)


def test_rules_always_divisible_for_all_archs():
    """Every resolved rule divides the tensor dims it shards, for every arch
    on both production mesh shapes (``test_properties.py``'s property)."""
    for shape in MESHES.values():
        mesh = FakeMesh(shape)
        for arch in ARCHS:
            cfg = tcfgs.get_config(arch)
            rules = tsh.make_rules(cfg, mesh, fsdp=True)
            for path, spec in t_build(cfg).param_specs().items():
                s = tsh.spec_for(spec.axes, rules)
                tsh.check_divisible(spec.shape, s, mesh, f"{arch} {path}")
                for dim, ax in zip(spec.shape, spec.axes):
                    r = rules.get(ax) if ax else None
                    if r:
                        size = int(np.prod([shape[a] for a in r]))
                        assert dim % size == 0, (arch, path, ax, dim, size)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    jm = j_build(jcfgs.get_config(arch))
    tm = t_build(tcfgs.get_config(arch))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ja = jmodule.abstract_params(jm.param_specs(), jdt)
        ta = tm.abstract_params(tdt)
        assert sorted(ta) == sorted(ja)
        for k, t in ta.items():
            assert t.is_meta and tuple(t.shape) == ja[k].shape
            assert t.dtype == tdt and ja[k].dtype == jdt


@pytest.mark.parametrize("arch", ["nemotron-4-340b",
                                  "llama4-maverick-400b-a17b"])
def test_abstract_params_count_largest_archs_without_memory(arch):
    model = t_build(tcfgs.get_config(arch))
    params = model.abstract_params()
    assert all(p.is_meta for p in params.values())
    assert sum(p.numel() for p in params.values()) == model.param_count()
    assert model.param_count() == j_build(jcfgs.get_config(arch)).param_count()


def test_sharding_placements_and_local_shapes(fake_meshes):
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake_meshes["multipod"]
    s = tsh.Sharding(mesh, (("pod", "data"), None, "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    assert s.local_shape((64, 3, 32)) == (2, 3, 2)
    # the serving-2D spec: one dim over model then data; DTensor orders the
    # splits by mesh dim, the per-device shape is the same
    s2 = tsh.Sharding(mesh, (("model", "data"), None))
    assert s2.placements == (Replicate(), Shard(0), Shard(0))
    assert s2.local_shape((512, 7)) == (2, 7)
    assert tsh.Sharding(mesh, ()).placements == (Replicate(),) * 3
    with pytest.raises(ValueError):
        s.local_shape((48, 3, 32))


def test_shard_is_identity_outside_a_context():
    x = torch.randn(4, 8)
    assert tsh.current_ctx() is None
    assert tsh.shard(x, ("batch", None)) is x
    assert tsh.axis_ways("seq") == 0


def test_shard_inside_a_context():
    cfg = tcfgs.smoke_config("llama3.2-1b")
    mesh = FakeMesh({"model": 4})
    rules = tsh.make_rules(cfg, mesh)
    x = torch.randn(2, 8, 4, 16)
    with tsh.sharding_ctx(mesh, rules):
        assert tsh.axis_ways("seq") == 4
        assert tsh.shard(x, ("batch", None, "heads", None)) is x
        with pytest.raises(ValueError, match="divide"):
            tsh.shard(torch.randn(2, 6, 4, 16), ("batch", "seq", None, None))
    assert tsh.current_ctx() is None


def test_shard_refuses_a_plain_tensor_on_a_device_mesh(fake_meshes):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = fake_meshes["pod"]
    cfg = tcfgs.smoke_config("llama3.2-1b")
    axes = ("batch", None, None, None)
    with tsh.sharding_ctx(mesh, tsh.make_rules(cfg, mesh)):
        with pytest.raises(ValueError, match="device mesh"):
            tsh.shard(torch.randn(16, 8, 4, 16), axes)
        meta = torch.empty(16, 8, 4, 16, device="meta")
        assert tsh.shard(meta, axes) is meta
        with FakeTensorMode():
            fake = torch.empty(16, 8, 4, 16)
            assert tsh.shard(fake, axes) is fake


def test_shard_redistributes_a_dtensor_and_kernels_refuse_one():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh

    try:
        mesh = make_host_mesh("cpu")
        cfg = tcfgs.smoke_config("llama3.2-1b")
        rules = tsh.make_rules(cfg, mesh)
        x = torch.randn(2, 8, 64)
        d = distribute_tensor(x, mesh, (Replicate(), Replicate()),
                              src_data_rank=None)
        with tsh.sharding_ctx(mesh, rules):
            y = tsh.shard(d, ("batch", None, "mlp_act"))
            assert tsh.shard(x, ("batch", None, "mlp_act")) is x
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert torch.equal(y.full_tensor(), x)
        with pytest.raises(TypeError, match="DTensor"):
            _build.ptr(y)
    finally:
        destroy_group()


# ------------------------------------------------------- context parallel
def _qkv(rng, shape_q, shape_kv):
    q = rng.normal(size=shape_q).astype(np.float32)
    k = rng.normal(size=shape_kv).astype(np.float32)
    v = rng.normal(size=shape_kv).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 24])
def test_cp_attention_matches_reference(rng, window):
    q, k, v = _qkv(rng, (2, 64, 4, 16), (2, 64, 2, 16))
    want = j_cp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                window=window, q_chunk=16, ways=4)
    got = cp_chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               window=window, q_chunk=16, ways=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # and the flash-attention kernel's plain version, the non-cp path
    from repro_torch.modeling.attention import attention

    plain = attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                      window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_cp_attention_grad_matches_reference(rng):
    q, k, v = _qkv(rng, (1, 32, 2, 8), (1, 32, 2, 8))
    g_ref = jax.grad(lambda q: j_cp(q, jnp.asarray(k), jnp.asarray(v),
                                    q_chunk=8, ways=2).sum())(jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_(True)
    cp_chunked_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                         q_chunk=8, ways=2).sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("sp_acts", [False, True])
def test_lm_under_context_parallelism_keeps_its_loss(rng, sp_acts):
    from repro_torch.modeling.registry import build_model

    cfg = tcfgs.smoke_config("llama3.2-1b").with_updates(cp_attn=True,
                                                         sp_acts=sp_acts)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cpu")
    B, S = 2, 32
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                              .astype(np.int32))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1),
             "loss_mask": torch.ones(B, S)}
    plain, _ = model.loss(params, batch)
    mesh = FakeMesh({"model": 4})
    with tsh.sharding_ctx(mesh, tsh.make_rules(cfg, mesh)):
        assert tsh.axis_ways("seq") == 4
        cp, _ = model.loss(params, batch)
    assert abs(float(cp) - float(plain)) <= 1e-5
