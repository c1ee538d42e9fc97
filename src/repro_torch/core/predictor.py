"""The Predictor (paper Sec. V-A), generalized to multi-device edge fleets.

Given an input, the Predictor returns predicted end-to-end latency and cost for
every execution target: the N cloud configurations Φ = {λ_m} and every device
of the edge fleet. Cold-vs-warm start is decided by consulting the CIL. The
Decision Engine then calls ``update_cil`` with the chosen configuration.

Targets are pluggable so the same Predictor drives both the AWS reproduction
(LambdaTarget/EdgeTarget, models from Sec. IV) and the TPU-fleet adaptation
(``repro_torch.serving.placement.SliceTarget``).

The paper assumes ONE smart edge device per application; ``EdgeFleet`` lifts
that to N named devices, each with its own compute model (heterogeneous fleets
via ``repro_torch.core.perf_models.ScaledModel``) and its own predicted FIFO queue.
``Predictor(edge_target=...)`` survives as the single-device convenience and
builds a one-device fleet.

Two prediction paths:

- ``predict(task, now)`` — the paper's per-task call: consult the CIL, return
  one ``Prediction`` per target;
- ``predict_batch(tasks)`` + ``predict_at(batch, i, now)`` — the batched API:
  every component model (ridge/normal/GBRT — all accept arrays) is evaluated
  ONCE over all tasks × targets, for both the warm and the cold start variant;
  ``predict_at`` then assembles the per-task view by consulting the CIL, which
  is the only genuinely sequential part. ``DecisionEngine.place_many`` builds
  on this; results are identical to per-task ``predict`` (same models, same
  arithmetic, vectorized).

On the batched path the GBRT compute model can additionally be routed through
the CUDA ensemble kernel of ``repro_torch.kernels.gbrt_predict``: the route
is decided by the Predictor's ``device`` alone. On a CUDA device,
batches of >= ``GBRT_KERNEL_MIN_BATCH`` rows run the float64 tree-walk kernel,
which is bit-identical to the numpy walk and to the cached step tables.
Everywhere else (``device`` None or the CPU) the cached step tables serve.
There is no silent fallback: on CUDA the route launches the kernel or raises.

The ``quantile`` option is a beyond-paper extension (the paper's stated future
work): predict a latency quantile instead of the mean, so placement can hedge
against the high variance the paper observed in cloud pipelines.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from dataclasses import dataclass, field
from typing import Mapping, Protocol

import numpy as np

from repro_torch.core.cil import ContainerInfoList
from repro_torch.core.perf_models import NormalModel, RidgeModel, ScaledModel, _norm_ppf
from repro_torch.core.pricing import EdgePricing, LambdaPricing
from repro_torch.core.workload import task_arrays

EDGE = "edge"

# smallest batch the CUDA GBRT kernel serves on a CUDA device (the cached
# step tables serve smaller batches and every batch off the card)
GBRT_KERNEL_MIN_BATCH = 4096


def _on_cuda(device) -> bool:
    return device is not None and getattr(device, "type", None) == "cuda"


def _kernel_route(model, n: int, device) -> bool:
    return (hasattr(model, "thresholds") and n >= GBRT_KERNEL_MIN_BATCH
            and _on_cuda(device))


# Serving-side GBRT step-table cache, keyed ``(id(model), comp_feature)``.
# The chunked/streaming serve path calls ``predict_batch`` once per chunk; the
# table must be derived once per (model, memory config) for a whole stream,
# not once per call. Keying on the model's *identity* (with a weakref guard
# against id reuse) makes online-refit invalidation automatic: a refit swaps
# in a fresh model object (never mutates a fitted one — see ROADMAP), so the
# fresh model simply misses the cache and builds its own table, and the stale
# entry is evicted the moment its id is recycled or the sweep finds it dead.
# The lock covers the sharded thread mode: shards predict concurrently, and
# an unlocked sweep could iterate while another thread inserts.
_CONST1_TABLES: dict[tuple[int, float], tuple] = {}
_CONST1_LOCK = threading.Lock()


def model_keyed_cache(cache: dict, lock: threading.Lock, key, models, build):
    """The ``_CONST1_TABLES`` idiom as a reusable helper: a module-level cache
    keyed on model *identities* (with weakref guards against id recycling),
    so refit-by-swap invalidation is automatic — a refit swaps in fresh model
    objects (never mutates fitted ones, see ROADMAP), the fresh ids miss the
    cache, and stale entries are evicted on id recycle or the size-capped
    dead-ref sweep. ``models`` are the guarded objects (kept alive by the
    caller for the entry to stay valid); ``build`` is the zero-arg derivation.
    Shared by the serving step tables below and the device-resident core's
    operand/table hosting (``repro_torch.core.torch_core``) — per-chunk paths must
    never re-derive per-model artifacts.
    """
    with lock:
        hit = cache.get(key)
        if hit is not None:
            refs, val = hit
            if all(r() is m for r, m in zip(refs, models)):
                return val
            cache.pop(key, None)  # id recycled by a swap: stale
    val = build()
    try:
        refs = tuple(weakref.ref(m) for m in models)
    except TypeError:
        return val  # non-weakrefable model: serve uncached
    with lock:
        if len(cache) > 256:  # drop entries whose model is gone
            for k in [k for k, (rs, _) in cache.items()
                      if any(r() is None for r in rs)]:
                cache.pop(k, None)
        cache[key] = (refs, val)
    return val


def _const1_table(model, c: float) -> tuple[np.ndarray, np.ndarray]:
    return model_keyed_cache(
        _CONST1_TABLES, _CONST1_LOCK, (id(model), float(c)), (model,),
        lambda: model.const1_table(float(c)))


def const1_serving_table(model, c: float) -> tuple[np.ndarray, np.ndarray]:
    """Public handle on the cached serving step table ``(breaks, vals)`` for
    one ``(model, comp_feature)`` pair — the same weakref-guarded entries the
    numpy hot path reads, so a consumer that re-hosts the table (e.g. the
    device-resident torch core's gather operands) sees bit-identical values and
    inherits refit-by-swap invalidation for free (fresh model ⇒ fresh id ⇒
    cache miss)."""
    return _const1_table(model, float(c))


def _const1_eval(model, x0: np.ndarray, c: float) -> np.ndarray:
    """One cached-table lookup — the single implementation both batched
    entry points share (bit-identical to ``GBRT.predict_const1``)."""
    breaks, vals = _const1_table(model, c)
    return vals[np.searchsorted(breaks, x0, side="left")]


def gbrt_predict_const(model, x0: np.ndarray, c: float,
                       device=None) -> np.ndarray:
    """Batched GBRT predict with feature 1 fixed at ``c`` — no feature stack.

    The serving pipeline's compute models are always evaluated at one
    ``comp_feature`` per cloud target (memory_mb / chips), so the hot path
    never needs the ``(n, 2)`` stack, the per-call constant-column scan, or a
    re-derived step table: the cached ``(breaks, vals)`` pair turns the call
    into one ``searchsorted``. Bit-identical to the tree walk (see
    ``GBRT.predict_const1``); the CUDA kernel route and arbitrary models
    take the stacked ``gbrt_batch_predict``.
    """
    x0 = np.asarray(x0, dtype=np.float64)
    kernel = _kernel_route(model, x0.shape[0], device)
    if not kernel and hasattr(model, "const1_table"):
        return _const1_eval(model, x0, c)
    feats = np.stack([x0, np.full(x0.shape[0], float(c))], axis=1)
    return gbrt_batch_predict(model, feats, device)


def gbrt_batch_predict(model, feats: np.ndarray, device=None) -> np.ndarray:
    """Batched GBRT evaluation: the float64 CUDA ensemble kernel on a CUDA
    ``device`` (batches >= ``GBRT_KERNEL_MIN_BATCH``), the constant-feature
    step-function table for the serving pipeline's
    (size, memory_mb)-with-fixed-memory calls, the vectorized numpy tree walk
    otherwise. All three are bit-identical (the kernel accumulates
    ``acc + lr * leaf`` in tree order in float64, exactly like
    ``GBRT.predict``; the table path is the walk at one representative point
    per segment, see ``GBRT.predict_const1``).
    """
    if _kernel_route(model, feats.shape[0], device):
        import torch

        from repro_torch.kernels.gbrt_predict.ops import gbrt_predict

        x = torch.as_tensor(np.asarray(feats, np.float64), device=device)
        return gbrt_predict(model, x).cpu().numpy()
    if (hasattr(model, "const1_table") and feats.ndim == 2
            and feats.shape[1] == 2 and feats.shape[0] > 0
            and np.all(feats[:, 1] == feats[0, 1])):
        return _const1_eval(model, np.asarray(feats[:, 0], np.float64),
                            float(feats[0, 1]))
    return np.asarray(model.predict(feats), dtype=np.float64)


@dataclass(frozen=True)
class Prediction:
    target: str
    latency_ms: float
    cost: float
    cold: bool
    components: Mapping[str, float]

    @property
    def comp_ms(self) -> float:
        return self.components.get("comp", 0.0)


class ExecutionTarget(Protocol):
    """A place a task can run: a cloud config λ_m, the edge device, a TPU slice."""

    name: str
    is_edge: bool

    def predict_components(self, task, cold: bool, quantile: float | None) -> dict[str, float]:
        """Latency components in ms. Must include a 'comp' entry."""
        ...

    def predict_components_batch(self, sizes: np.ndarray, nbytes: np.ndarray,
                                 quantile: float | None) -> tuple[dict, dict | None]:
        """Vectorized components for n tasks: (warm, cold) dicts of (n,) arrays.

        ``cold`` is ``None`` for always-warm targets (the edge). Optional —
        ``Predictor.predict_batch`` falls back to per-task calls when absent.
        """
        ...

    def cost(self, comp_ms: float) -> float:
        ...

    def cost_batch(self, comp_ms: np.ndarray) -> np.ndarray:
        """Vectorized ``cost`` over an array of compute times. Optional."""
        ...

    def occupancy_ms(self, components: dict[str, float]) -> float:
        """How long the executor/container is held busy (for CIL bookkeeping)."""
        ...


@dataclass
class EdgeFleet:
    """Named edge devices — the multi-device generalization of λ_edge.

    Every device is an edge execution target (``EdgeTarget``,
    ``EdgeSliceTarget``, any ``is_edge`` target) with a unique name. Devices
    may carry distinct compute models, so heterogeneous fleets (a fast hub
    plus slow sensor nodes) are first-class: see ``replicate(speeds=...)``.
    """

    devices: list

    def __post_init__(self):
        names = [d.name for d in self.devices]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate edge device names: {names}")
        for d in self.devices:
            if not getattr(d, "is_edge", False):
                raise ValueError(f"edge device {d.name!r} must have is_edge=True")
        self._by_name = {d.name: d for d in self.devices}

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(d.name for d in self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __bool__(self) -> bool:
        return bool(self.devices)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __getitem__(self, name: str):
        return self._by_name[name]

    @classmethod
    def single(cls, target) -> "EdgeFleet":
        """The paper's one-device special case."""
        return cls([target])

    @classmethod
    def replicate(cls, target, n: int, prefix: str = "edge",
                  speeds: Mapping[str, float] | None = None) -> "EdgeFleet":
        """N copies of ``target`` named ``{prefix}0..{prefix}{n-1}``.

        ``speeds`` maps device name → relative compute speed (1.0 = the base
        device); a device at speed ``s`` gets ``comp_model`` wrapped in
        ``ScaledModel(base, 1/s)``.
        """
        speeds = speeds or {}
        return cls.from_speeds(
            target, {f"{prefix}{i}": float(speeds.get(f"{prefix}{i}", 1.0))
                     for i in range(n)})

    @classmethod
    def from_speeds(cls, target, speeds: Mapping[str, float]) -> "EdgeFleet":
        """One device per ``speeds`` entry (arbitrary names, fleet order =
        mapping order); a device at speed ``s`` predicts ``comp / s``."""
        devices = []
        for name, speed in speeds.items():
            dev = dataclasses.replace(target, name=name)
            if float(speed) != 1.0:
                dev = dataclasses.replace(
                    dev, comp_model=ScaledModel(dev.comp_model, 1.0 / float(speed)))
            devices.append(dev)
        return cls(devices)


@dataclass(frozen=True)
class TargetBatch:
    """Vectorized predictions for one target across a batch of tasks."""

    warm: dict[str, np.ndarray]          # component -> (n,) ms
    cold: dict[str, np.ndarray] | None   # None for always-warm targets
    warm_latency: np.ndarray             # (n,) — sum of warm components
    cold_latency: np.ndarray | None
    cost: np.ndarray                     # (n,) — cost depends on comp only


@dataclass(frozen=True)
class PredictionBatch:
    """All component-model evaluations for a batch of tasks, both start modes.

    Warm/cold selection and edge queueing are *not* baked in — they depend on
    sequential CIL / edge-queue state and are resolved per task by
    ``Predictor.predict_at``.
    """

    n: int
    cloud: dict[str, TargetBatch]
    edges: dict[str, TargetBatch]        # device name -> batch (fleet order)

    # ------------------------- deprecated single-edge convenience accessors
    @property
    def edge(self) -> TargetBatch | None:
        return next(iter(self.edges.values()), None)

    @property
    def edge_name(self) -> str | None:
        return next(iter(self.edges), None)


def cloud_components_batch(sizes: np.ndarray, nbytes: np.ndarray, *,
                           comp_feature: float, comp_model, upld_model,
                           start_warm: NormalModel, start_cold: NormalModel,
                           store_model: NormalModel, comp_std_frac: float,
                           quantile: float | None,
                           device=None) -> tuple[dict, dict]:
    """Shared vectorized cloud pipeline: upld + start + comp + store.

    One source of truth for the batch variant of the cloud-target component
    math (``LambdaTarget`` with ``memory_mb``, ``SliceTarget`` with
    ``chips``), so the scalar/batch parity guarantee has a single place to
    break — and a parity test to catch it. ``device`` routes the GBRT
    column (see ``gbrt_batch_predict``).
    """
    n = sizes.shape[0]
    comp = gbrt_predict_const(comp_model, sizes, comp_feature, device)
    if quantile is not None:
        z = _norm_ppf(quantile)
        comp = comp * (1.0 + z * comp_std_frac)
        warm_start = start_warm.predict_quantile(quantile)
        cold_start = start_cold.predict_quantile(quantile)
        store_ms = store_model.predict_quantile(quantile)
    else:
        warm_start = start_warm.predict()
        cold_start = start_cold.predict()
        store_ms = store_model.predict()
    warm = {
        "upld": np.maximum(np.asarray(upld_model.predict(nbytes)), 0.0),
        "start": np.full(n, max(warm_start, 0.0)),
        "comp": np.maximum(comp, 0.0),
        "store": np.full(n, max(store_ms, 0.0)),
    }
    cold = dict(warm, start=np.full(n, max(cold_start, 0.0)))
    return warm, cold


def edge_components_batch(sizes: np.ndarray, *, comp_model,
                          store_model: NormalModel, comp_std_frac: float,
                          quantile: float | None,
                          iotup_model: NormalModel | None = None) -> tuple[dict, None]:
    """Shared vectorized edge pipeline: comp + iotup + store (always warm).

    ``iotup_model=None`` means the pipeline has no IoT upload leg (the
    TPU-slice edge); the component is emitted as zeros for shape parity.
    """
    n = sizes.shape[0]
    comp = np.asarray(comp_model.predict(sizes), dtype=np.float64)
    if quantile is not None:
        z = _norm_ppf(quantile)
        comp = comp * (1.0 + z * comp_std_frac)
        iot = iotup_model.predict_quantile(quantile) if iotup_model else 0.0
        store = store_model.predict_quantile(quantile)
    else:
        iot = iotup_model.predict() if iotup_model else 0.0
        store = store_model.predict()
    warm = {"comp": np.maximum(comp, 0.0),
            "iotup": np.full(n, max(iot, 0.0)),
            "store": np.full(n, max(store, 0.0))}
    return warm, None


def _stack_components(tgt, sizes: np.ndarray, nbytes: np.ndarray,
                      quantile: float | None) -> tuple[dict, dict | None]:
    """Per-task fallback for targets without ``predict_components_batch``."""

    @dataclass
    class _Row:
        size: float
        bytes: float

    def rows(cold: bool) -> dict[str, np.ndarray]:
        per = [tgt.predict_components(_Row(float(s), float(b)), cold, quantile)
               for s, b in zip(sizes, nbytes)]
        return {k: np.array([p[k] for p in per]) for k in per[0]}

    warm = rows(False)
    cold = None if tgt.is_edge else rows(True)
    return warm, cold


@dataclass
class Predictor:
    """predict() + update_cil(), exactly the two methods of paper Sec. V-A —
    plus the batched ``predict_batch``/``predict_at`` pair.

    ``edge_fleet`` is the first-class multi-device form; ``edge_target`` is
    the deprecated single-device convenience (it becomes a one-device fleet).
    """

    cloud_targets: list
    edge_target: object | None = None
    cil: ContainerInfoList = field(default_factory=ContainerInfoList)
    quantile: float | None = None  # None = paper-faithful mean prediction
    edge_fleet: EdgeFleet | None = None
    # torch device of the batched GBRT kernel route (None = host tables);
    # ``DecisionEngine`` sets it to its own device
    device: object = None

    def __post_init__(self):
        self._by_name = {t.name: t for t in self.cloud_targets}
        if self.edge_fleet is not None and self.edge_target is not None:
            raise ValueError("pass either edge_fleet or edge_target, not both")
        if self.edge_fleet is None and self.edge_target is not None:
            self.edge_fleet = EdgeFleet.single(self.edge_target)
        elif self.edge_fleet is not None and self.edge_target is None:
            # deprecated convenience alias: "the edge" = the fleet's first device
            self.edge_target = self.edge_fleet.devices[0] if self.edge_fleet else None

    @property
    def edge_names(self) -> tuple[str, ...]:
        return self.edge_fleet.names if self.edge_fleet is not None else ()

    def _edge_waits(self, edge_queue_wait_ms: float,
                    edge_waits: Mapping[str, float] | None) -> Mapping[str, float]:
        if edge_waits is not None:
            return edge_waits
        return {name: edge_queue_wait_ms for name in self.edge_names}

    def predict(self, task, now: float, edge_queue_wait_ms: float = 0.0,
                edge_waits: Mapping[str, float] | None = None) -> dict[str, Prediction]:
        """Predicted end-to-end latency and cost for every target.

        ``edge_waits`` maps device name → predicted FIFO queue wait; the
        scalar ``edge_queue_wait_ms`` is the deprecated single-edge spelling
        (applied to every device when ``edge_waits`` is not given).
        """
        self.cil.reap(now)
        waits = self._edge_waits(edge_queue_wait_ms, edge_waits)
        out: dict[str, Prediction] = {}
        for tgt in self.cloud_targets:
            cold = not self.cil.will_warm_start(tgt.name, now)
            comps = tgt.predict_components(task, cold, self.quantile)
            latency = sum(comps.values())
            out[tgt.name] = Prediction(
                target=tgt.name,
                latency_ms=latency,
                cost=tgt.cost(comps["comp"]),
                cold=cold,
                components=comps,
            )
        for dev in (self.edge_fleet or ()):
            wait = float(waits.get(dev.name, 0.0))
            comps = dev.predict_components(task, False, self.quantile)
            latency = wait + sum(comps.values())
            comps = dict(comps, queue=wait)
            out[dev.name] = Prediction(
                target=dev.name,
                latency_ms=latency,
                cost=dev.cost(comps["comp"]),
                cold=False,
                components=comps,
            )
        return out

    # ----------------------------------------------------------- batched API
    def predict_batch(self, tasks: list) -> PredictionBatch:
        """Evaluate every component model over all (tasks × targets) at once —
        cloud configs AND every edge device of the fleet.

        One numpy pass per (target, start-mode) instead of a Python loop per
        task — the GBRT compute model alone turns N×M tree walks into M (and
        can run on the CUDA ensemble kernel, see ``gbrt_batch_predict``).
        """
        if not tasks:
            return PredictionBatch(n=0, cloud={}, edges={})
        _, _, sizes, nbytes = task_arrays(tasks, "sb")

        cloud: dict[str, TargetBatch] = {}
        for tgt in self.cloud_targets:
            cloud[tgt.name] = self._target_batch(tgt, sizes, nbytes)
        edges: dict[str, TargetBatch] = {}
        for dev in (self.edge_fleet or ()):
            edges[dev.name] = self._target_batch(dev, sizes, nbytes)
        return PredictionBatch(n=len(tasks), cloud=cloud, edges=edges)

    def _target_batch(self, tgt, sizes: np.ndarray, nbytes: np.ndarray) -> TargetBatch:
        if type(tgt) is LambdaTarget:
            warm, cold = tgt.predict_components_batch(
                sizes, nbytes, self.quantile, device=self.device)
        elif hasattr(tgt, "predict_components_batch"):
            warm, cold = tgt.predict_components_batch(sizes, nbytes, self.quantile)
            if cold is not None and getattr(tgt, "is_edge", False):
                # always-warm targets never cold-start: drop any cold = warm
                # stack a custom target hands back instead of carrying (and
                # re-summing) a duplicate component set per chunk
                cold = None
        else:
            warm, cold = _stack_components(tgt, sizes, nbytes, self.quantile)
        if hasattr(tgt, "cost_batch"):
            cost = np.asarray(tgt.cost_batch(warm["comp"]), dtype=np.float64)
        else:
            cost = np.array([tgt.cost(float(c)) for c in warm["comp"]])
        return TargetBatch(
            warm=warm, cold=cold,
            warm_latency=sum(warm.values()),
            cold_latency=sum(cold.values()) if cold is not None else None,
            cost=cost,
        )

    def predict_at(self, batch: PredictionBatch, idx: int, now: float,
                   edge_queue_wait_ms: float = 0.0,
                   edge_waits: Mapping[str, float] | None = None) -> dict[str, Prediction]:
        """Assemble the per-task view of a ``PredictionBatch``: consult the CIL
        for warm/cold per cloud target, add each device's predicted queue wait.

        Equivalent to ``predict(tasks[idx], now, ...)``."""
        self.cil.reap(now)
        waits = self._edge_waits(edge_queue_wait_ms, edge_waits)
        out: dict[str, Prediction] = {}
        for name, tb in batch.cloud.items():
            cold = not self.cil.will_warm_start(name, now)
            src = tb.cold if cold else tb.warm
            lat = tb.cold_latency if cold else tb.warm_latency
            out[name] = Prediction(
                target=name,
                latency_ms=float(lat[idx]),
                cost=float(tb.cost[idx]),
                cold=cold,
                components={k: float(v[idx]) for k, v in src.items()},
            )
        for name, tb in batch.edges.items():
            wait = float(waits.get(name, 0.0))
            comps = {k: float(v[idx]) for k, v in tb.warm.items()}
            comps["queue"] = wait
            out[name] = Prediction(
                target=name,
                latency_ms=wait + float(tb.warm_latency[idx]),
                cost=float(tb.cost[idx]),
                cold=False,
                components=comps,
            )
        return out

    def prewarm(self, target: str, ready_ms: float,
                keepalive_until_ms: float):
        """Register a speculatively spawned container for a cloud target.

        The returned ``ContainerRecord`` is warm over exactly
        ``[ready_ms, keepalive_until_ms]`` (see ``ContainerInfoList.prewarm``
        for the encoding), so every warm/cold consult — ``predict``,
        ``predict_at``, and the columnar decision core — sees the prewarmed
        pool with no further plumbing. Edge devices have no containers.
        """
        self._target(target)  # raises KeyError for unknown/edge names
        return self.cil.prewarm(target, ready_ms, keepalive_until_ms)

    # ------------------------------------------------------------ CIL update
    def update_cil(self, chosen: str, now: float, prediction: Prediction) -> None:
        """Record the chosen placement (paper: Predictor.updateCIL)."""
        if self.edge_fleet is not None and chosen in self.edge_fleet:
            return  # edge executor state is tracked by its FIFO queue, not the CIL
        tgt = self._target(chosen)
        completion = now + tgt.occupancy_ms(dict(prediction.components))
        self.cil.record_dispatch(chosen, now, completion)

    def _target(self, name: str):
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"unknown target {name!r}") from None


@dataclass
class LambdaTarget:
    """Cloud pipeline target: T_c(k) = upld(k) + start(m) + comp(k,m) + store(k)."""

    name: str
    memory_mb: float
    upld_model: RidgeModel
    start_warm: NormalModel
    start_cold: NormalModel
    comp_model: object  # GBRT over features (size, memory_mb)
    store_model: NormalModel
    pricing: LambdaPricing = field(default_factory=LambdaPricing)
    comp_std_frac: float = 0.0  # relative comp std for quantile prediction
    is_edge: bool = False

    def predict_components(self, task, cold: bool, quantile: float | None = None) -> dict[str, float]:
        start = self.start_cold if cold else self.start_warm
        comp = float(self.comp_model.predict(np.array([[task.size, self.memory_mb]]))[0])
        if quantile is not None:
            z = _norm_ppf(quantile)
            comp = comp * (1.0 + z * self.comp_std_frac)
            start_ms = start.predict_quantile(quantile)
            store_ms = self.store_model.predict_quantile(quantile)
        else:
            start_ms = start.predict()
            store_ms = self.store_model.predict()
        return {
            "upld": max(float(self.upld_model.predict(task.bytes)), 0.0),
            "start": max(start_ms, 0.0),
            "comp": max(comp, 0.0),
            "store": max(store_ms, 0.0),
        }

    def predict_components_batch(self, sizes: np.ndarray, nbytes: np.ndarray,
                                 quantile: float | None = None,
                                 device=None) -> tuple[dict, dict]:
        return cloud_components_batch(
            sizes, nbytes, comp_feature=self.memory_mb,
            comp_model=self.comp_model, upld_model=self.upld_model,
            start_warm=self.start_warm, start_cold=self.start_cold,
            store_model=self.store_model, comp_std_frac=self.comp_std_frac,
            quantile=quantile, device=device)

    def cost(self, comp_ms: float) -> float:
        return self.pricing.cost(comp_ms, self.memory_mb)

    def cost_batch(self, comp_ms: np.ndarray) -> np.ndarray:
        return self.pricing.cost_batch(comp_ms, self.memory_mb)

    def occupancy_ms(self, components: dict[str, float]) -> float:
        # The container is held from dispatch until the function returns:
        # upload + start + compute (storage happens after release).
        return components["upld"] + components["start"] + components["comp"]


@dataclass
class EdgeTarget:
    """Edge pipeline target: T_e(k) = comp(k) + iotup(k) + store(k) (+ queue wait)."""

    comp_model: RidgeModel
    iotup_model: NormalModel
    store_model: NormalModel
    pricing: EdgePricing = field(default_factory=EdgePricing)
    comp_std_frac: float = 0.0
    name: str = EDGE
    is_edge: bool = True

    def predict_components(self, task, cold: bool = False, quantile: float | None = None) -> dict[str, float]:
        comp = float(self.comp_model.predict(task.size))
        if quantile is not None:
            z = _norm_ppf(quantile)
            comp = comp * (1.0 + z * self.comp_std_frac)
            iot = self.iotup_model.predict_quantile(quantile)
            store = self.store_model.predict_quantile(quantile)
        else:
            iot = self.iotup_model.predict()
            store = self.store_model.predict()
        return {"comp": max(comp, 0.0), "iotup": max(iot, 0.0), "store": max(store, 0.0)}

    def predict_components_batch(self, sizes: np.ndarray, nbytes: np.ndarray,
                                 quantile: float | None = None) -> tuple[dict, None]:
        return edge_components_batch(
            sizes, comp_model=self.comp_model, store_model=self.store_model,
            comp_std_frac=self.comp_std_frac, quantile=quantile,
            iotup_model=self.iotup_model)

    def cost(self, comp_ms: float) -> float:
        return self.pricing.cost(comp_ms)

    def cost_batch(self, comp_ms: np.ndarray) -> np.ndarray:
        return self.pricing.cost_batch(comp_ms)

    def occupancy_ms(self, components: dict[str, float]) -> float:
        return components["comp"]
