"""Logical-axis sharding: one rules table maps logical axis names to mesh
axes (the port of ``repro.distributed.sharding``).

Every parameter (through ``ParamSpec.axes``) and key activation (through
``shard(x, axes)`` calls in the model code) is annotated with *logical*
names. ``make_rules(cfg, mesh)`` resolves those names to mesh axes, checking
divisibility per architecture: gemma-2b's 8 query heads cannot shard over a
16-way model axis, so "heads" resolves to None (replicated) there and the
d_ff/vocab axes carry the model parallelism instead.

A mesh is either a ``torch.distributed.device_mesh.DeviceMesh`` (its sizes
in ``.shape``, a tuple, its names in ``mesh_dim_names``) or any object whose
``.shape`` is a dict ``{axis name: size}``, as the reference's tests build
them; ``mesh_sizes`` reads both.

A spec is a plain tuple, one entry per tensor dim: None, an axis name, or a
tuple of names (``tuple(PartitionSpec)`` of the reference's). The
counterpart of ``NamedSharding`` is ``Sharding``: the mesh, the spec, the
DTensor placements (one ``Shard``/``Replicate`` per mesh dim) and the
per-device shape of a global shape. Where one tensor dim is split over two
mesh axes (``("pod", "data")``, the serving-2D ``("model", "data")``),
DTensor orders the splits by mesh dim and JAX in the spec's order: the
per-device shapes agree, the order of the shards over the devices may not.

``shard(x, axes)`` is a no-op outside a sharding context: it returns ``x``
itself, so single-card runs execute the exact same model code. Inside one it
resolves the spec and checks that each dim divides its ways; a DTensor is
redistributed to the spec's placements. A plain tensor is returned as it is
where it holds the whole value and there is nothing to place it on: on a
mesh whose axes all have size 1 (one card), on a mesh that only names its
axes' sizes (a ``.shape`` dict, no devices), or when it has no data (a fake
or meta tensor, as the dry run traces). On a ``DeviceMesh`` of more than
one device a plain tensor with data is refused (``ValueError``): it would
pass as replicated unchecked. The kernels take plain tensors only
(``_build.ptr`` refuses a DTensor).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

_STATE = threading.local()


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of an object whose
    ``.shape`` is such a dict."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


@dataclass(frozen=True)
class ShardingCtx:
    mesh: object
    rules: dict[str, tuple[str, ...] | None]


def axes_size(sizes: dict[str, int], axes) -> int:
    """The product of the sizes of mesh ``axes`` (None or any iterable of
    names; 1 for none) in ``sizes`` (``mesh_sizes``)."""
    if axes is None:
        return 1
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def make_rules(cfg, mesh, fsdp: bool = False,
               serving: bool = False) -> dict[str, tuple[str, ...] | None]:
    """Resolve logical axis names to mesh axes for one architecture.

    ``serving=True`` with ``cfg.serve_2d_ffn``: FFN and expert-FFN weight
    dims shard over model x data, so giant serving weights are fully
    distributed without per-step FSDP all-gathers."""
    sizes = mesh_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    model_ax = ("model",) if "model" in sizes else None

    def if_div(dim: int, axes):
        return axes if axes and dim % axes_size(sizes, axes) == 0 else None

    kv_heads = if_div(getattr(cfg, "n_kv_heads", 0) or 0, model_ax)

    # "rnn" names several related recurrent widths; shard only if every
    # tensor dim carrying it divides the model axis. For the SSM that is the
    # in_proj output (2 d_inner + 2 ds + nh), the conv channel
    # (d_inner + 2 ds) and d_inner itself; for Griffin it is d_rnn.
    rnn_dims: list[int] = []
    if getattr(cfg, "d_rnn", 0):
        rnn_dims = [cfg.d_rnn]
    elif getattr(cfg, "ssm_state", 0):
        d_inner = cfg.ssm_expand * cfg.d_model
        nh = d_inner // cfg.ssm_head_dim
        ds = cfg.ssm_state
        rnn_dims = [2 * d_inner + 2 * ds + nh, d_inner + 2 * ds, d_inner]
    rnn_ok = bool(rnn_dims) and all(
        d % axes_size(sizes, model_ax) == 0 for d in rnn_dims)

    n_experts = getattr(cfg, "n_experts", 0) or 0
    rules: dict[str, tuple[str, ...] | None] = {
        "batch": data_axes or None,
        "embed": None,
        "embed_fsdp": None,
        "heads": if_div(cfg.n_heads, model_ax),
        "kv_heads": kv_heads,
        "head_dim": None,
        "mlp": if_div(cfg.d_ff or 0, model_ax),
        "vocab": if_div(cfg.vocab, model_ax),
        "experts": if_div(n_experts, model_ax),
        # expert-internal FF: over model only when the experts cannot be
        # (one mesh axis must not appear twice in a spec)
        "expert_mlp": (
            None if if_div(n_experts, model_ax)
            else if_div(getattr(cfg, "d_ff_expert", 0) or 0, model_ax)),
        "rnn_blocks": if_div(getattr(cfg, "rglru_block_gates", 0) or 0,
                             model_ax),
        # activation counterpart of "mlp": model only (activations are
        # already batch-sharded over the data axes)
        "mlp_act": if_div(cfg.d_ff or 0, model_ax),
        "rnn": model_ax if rnn_ok else None,
        "ssm_heads": if_div(
            (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim)
            if getattr(cfg, "ssm_state", 0) else 0, model_ax),
        "layers": None,
        # activation sequence axis: read only by the cp_attn / sp_acts
        # knobs (gated in the model code)
        "seq": model_ax,
        # GQA/MQA with few KV heads: shard the KV cache's sequence axis over
        # the model axis instead (flash-decode style)
        "kv_seq": model_ax if (model_ax and kv_heads is None
                               and (getattr(cfg, "n_kv_heads", 0) or 0) > 0)
                  else None,
    }
    if serving and getattr(cfg, "serve_2d_ffn", False):
        mlp2d = (model_ax or ()) + data_axes
        if cfg.d_ff and cfg.d_ff % axes_size(sizes, mlp2d) == 0:
            rules["mlp"] = mlp2d
        if rules["experts"] is not None:
            dfe = getattr(cfg, "d_ff_expert", 0) or 0
            rules["expert_mlp"] = if_div(dfe, data_axes)
    elif fsdp:
        # FSDP: shard the d_model axis of weights over the data axes too
        rules["embed"] = if_div(cfg.d_model, data_axes)
        rules["embed_fsdp"] = rules["embed"]
    return rules


def spec_for(axes, rules) -> tuple:
    """The spec of a tensor whose dims carry the logical ``axes``: per dim
    None, one mesh axis name, or a tuple of them."""
    parts = []
    for a in axes:
        r = rules.get(a) if a is not None else None
        if r is None:
            parts.append(None)
        elif len(r) == 1:
            parts.append(r[0])
        else:
            parts.append(tuple(r))
    return tuple(parts)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_ways(spec: tuple, mesh) -> tuple[int, ...]:
    """How many ways each tensor dim of ``spec`` is split on ``mesh``."""
    sizes = mesh_sizes(mesh)
    return tuple(axes_size(sizes, _entry_axes(e)) for e in spec)


def check_divisible(shape, spec: tuple, mesh, what: str = "tensor") -> None:
    """Raise ``ValueError`` unless every dim of ``shape`` divides the ways
    ``spec`` splits it on ``mesh``."""
    if len(spec) > len(shape):
        raise ValueError(f"{what}: spec {spec} has more entries than shape "
                         f"{tuple(shape)} has dims")
    for dim, (n, ways) in enumerate(zip(shape, spec_ways(spec, mesh))):
        if n % ways:
            raise ValueError(f"{what}: dim {dim} of {tuple(shape)} does not "
                             f"divide its {ways} ways ({spec[dim]})")


@dataclass(frozen=True)
class Sharding:
    """The counterpart of ``NamedSharding``: a spec on a mesh."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        """One ``Shard(tensor dim)`` or ``Replicate()`` per mesh dim, in
        the mesh's dim order (DTensor's)."""
        from torch.distributed.tensor import Replicate, Shard

        owner = {}
        for dim, entry in enumerate(self.spec):
            for a in _entry_axes(entry):
                owner[a] = dim
        return tuple(Shard(owner[a]) if a in owner else Replicate()
                     for a in mesh_sizes(self.mesh))

    def local_shape(self, shape) -> tuple[int, ...]:
        """The per-device shape of a tensor of global ``shape``."""
        check_divisible(shape, self.spec, self.mesh)
        ways = spec_ways(self.spec, self.mesh) + (1,) * (len(shape)
                                                         - len(self.spec))
        return tuple(n // w for n, w in zip(shape, ways))


def param_shardings(specs, rules, mesh) -> dict[str, Sharding]:
    """``Sharding``s for a ``param_specs`` dict."""
    return {path: Sharding(mesh, spec_for(s.axes, rules))
            for path, s in specs.items()}


# ------------------------------------------------------------------ context
@contextlib.contextmanager
def sharding_ctx(mesh, rules: dict):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ShardingCtx(mesh=mesh, rules=rules)
    try:
        yield
    finally:
        _STATE.ctx = prev


def current_ctx() -> ShardingCtx | None:
    return getattr(_STATE, "ctx", None)


def shard(x, axes):
    """Annotate activation ``x`` with logical axes; ``x`` itself without a
    context. See the module docstring."""
    ctx = current_ctx()
    if ctx is None:
        return x
    spec = spec_for(axes, ctx.rules)
    check_divisible(x.shape, spec, ctx.mesh, "shard")
    if type(x).__name__ == "DTensor":
        return x.redistribute(ctx.mesh, Sharding(ctx.mesh, spec).placements)
    sizes = mesh_sizes(ctx.mesh)
    if all(n == 1 for n in sizes.values()) \
            or isinstance(ctx.mesh.shape, dict) or _has_no_data(x):
        return x
    raise ValueError(f"shard: a plain {tuple(x.shape)} tensor on a "
                     f"{sizes} device mesh; distribute it (a "
                     "DTensor) or run it with no sharding context")


def _has_no_data(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return x.is_meta or isinstance(x, FakeTensor)


def axis_ways(logical: str) -> int:
    """Mesh size a logical axis resolves to (0 outside a sharding
    context)."""
    ctx = current_ctx()
    if ctx is None:
        return 0
    r = ctx.rules.get(logical)
    if not r:
        return 0
    return axes_size(mesh_sizes(ctx.mesh), r)
