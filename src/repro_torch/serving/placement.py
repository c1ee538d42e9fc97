"""The paper's placement framework over the accelerator slice catalog.

The port of ``repro.serving.placement``: the same Predictor / CIL / Decision
Engine (``repro_torch.core`` is target-agnostic) instantiated over slice
executors instead of Lambda containers:

- ``calibrate_catalog`` reproduces Sec. IV-C's data collection against REAL
  executions: warm runs per (task, slice config) for the comp GBRT, a few real
  cold starts per config for the cold-start model, feed/store samples;
- ``SliceTarget`` predicts the end-to-end latency components
  (feed → start → comp → store) and slice-seconds cost, per task or in one
  vectorized pass over a whole batch (``predict_components_batch``);
- ``LiveBackend`` implements the ``repro_torch.core.runtime.ExecutionBackend``
  contract over the real executor pool: ``execute(task, target, now)`` runs a
  genuine model execution and bills slice-seconds; ``probe_cold`` asks the
  pool whether a dispatch would pay a real cold start; ``execute_async``
  runs a whole dispatch plan through the pool's CONCURRENT loop — one worker
  thread per edge device and per cloud config, hedge legs as first-class
  races — and returns the same struct-of-arrays ``ExecutionBatch`` as the
  twin, so ``serve_async`` stays object-free over a columnar
  ``DecisionBatch``; results aggregate into the same columnar
  ``RecordBatch``-backed ``SimulationResult`` as the twin;
- ``make_live_runtime`` wires catalog → predictor → Decision Engine →
  ``PlacementRuntime`` over a ``LiveBackend``: the SAME serve loop as the
  simulator, against real executions (paper Sec. VI-B analog — Table V falls
  out). ``LivePlacementServer`` is the deprecated thin wrapper around it.

Device policy: ``calibrate_catalog``, ``make_live_runtime`` and
``LivePlacementServer`` take ``device=None``, which means the CUDA card and
raises without one; ``device="cpu"`` runs the executors (and the Decision
Engine) on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.cil import ContainerInfoList
from repro_torch.core.decision import DecisionEngine, Policy
from repro_torch.core.gbrt import GBRT, GBRTConfig
from repro_torch.core.perf_models import NormalModel, RidgeModel, _norm_ppf
from repro_torch.core.predictor import (
    EDGE,
    EdgeFleet,
    Predictor,
    cloud_components_batch,
    edge_components_batch,
)
from repro_torch.core.pricing import SlicePricing
from repro_torch.core.records import (  # noqa: F401 — re-export
    RecordBatch,
    SimulationResult,
    TaskRecord,
)
from repro_torch.core.faults import TRANSIENT, AdmissionPolicy, CircuitBreaker, RetryPolicy
from repro_torch.core.runtime import ExecutionBatch, ExecutionOutcome, PlacementRuntime
from repro_torch.core.workload import PoissonWorkload, TaskInput
from repro_torch.kernels._build import KernelLaunchError
from repro_torch.serving.executors import (
    ExecutorPool,
    LiveExecutor,
    NetworkProfile,
    SliceSpec,
    _Dispatch,
    make_pool,
)

# The always-on edge device is resource-constrained relative to cloud slices
# (the paper's RPi-vs-Lambda gap): fewer tokens retired per compiled step.
EDGE_SPEC = SliceSpec("edge", chips=1, tokens_per_step=2, is_edge=True)


# --------------------------------------------------------------------- target
@dataclass
class SliceTarget:
    """Cloud-side slice config λ_m: T(k) = feed(k) + start(m) + comp(k,m) + store."""

    name: str
    chips: int
    feed_model: RidgeModel
    start_warm: NormalModel
    start_cold: NormalModel
    comp_model: GBRT        # features: (n_tokens, chips)
    store_model: NormalModel
    pricing: SlicePricing = field(default_factory=SlicePricing)
    comp_std_frac: float = 0.0
    is_edge: bool = False

    def predict_components(self, task, cold: bool, quantile: float | None = None):
        start = self.start_cold if cold else self.start_warm
        comp = float(self.comp_model.predict(
            np.array([[task.size, float(self.chips)]]))[0])
        if quantile is not None:
            z = _norm_ppf(quantile)
            comp = comp * (1.0 + z * self.comp_std_frac)
            start_ms = start.predict_quantile(quantile)
            store_ms = self.store_model.predict_quantile(quantile)
        else:
            start_ms = start.predict()
            store_ms = self.store_model.predict()
        return {
            "upld": max(float(self.feed_model.predict(task.bytes)), 0.0),
            "start": max(start_ms, 0.0),
            "comp": max(comp, 0.0),
            "store": max(store_ms, 0.0),
        }

    def predict_components_batch(self, sizes: np.ndarray, nbytes: np.ndarray,
                                 quantile: float | None = None) -> tuple[dict, dict]:
        return cloud_components_batch(
            sizes, nbytes, comp_feature=float(self.chips),
            comp_model=self.comp_model, upld_model=self.feed_model,
            start_warm=self.start_warm, start_cold=self.start_cold,
            store_model=self.store_model, comp_std_frac=self.comp_std_frac,
            quantile=quantile)

    def cost(self, comp_ms: float) -> float:
        return self.pricing.cost(comp_ms, self.chips)

    def cost_batch(self, comp_ms: np.ndarray) -> np.ndarray:
        return self.pricing.cost_batch(comp_ms, self.chips)

    def occupancy_ms(self, components: dict[str, float]) -> float:
        return components["upld"] + components["start"] + components["comp"]


@dataclass
class EdgeSliceTarget:
    """The always-on 1-chip slice: T(k) = comp(k) + store(k) (+ queue wait)."""

    comp_model: RidgeModel
    store_model: NormalModel
    comp_std_frac: float = 0.0
    name: str = EDGE
    is_edge: bool = True

    def predict_components(self, task, cold: bool = False,
                           quantile: float | None = None):
        comp = float(self.comp_model.predict(task.size))
        if quantile is not None:
            z = _norm_ppf(quantile)
            comp = comp * (1.0 + z * self.comp_std_frac)
            store = self.store_model.predict_quantile(quantile)
        else:
            store = self.store_model.predict()
        return {"comp": max(comp, 0.0), "iotup": 0.0, "store": max(store, 0.0)}

    def predict_components_batch(self, sizes: np.ndarray, nbytes: np.ndarray,
                                 quantile: float | None = None) -> tuple[dict, None]:
        return edge_components_batch(
            sizes, comp_model=self.comp_model, store_model=self.store_model,
            comp_std_frac=self.comp_std_frac, quantile=quantile)

    def cost(self, comp_ms: float) -> float:  # noqa: ARG002
        return 0.0  # amortized to zero, paper Sec. II-A.2b

    def cost_batch(self, comp_ms: np.ndarray) -> np.ndarray:
        return np.zeros(np.asarray(comp_ms).shape[0], dtype=np.float64)

    def occupancy_ms(self, components: dict[str, float]) -> float:
        return components["comp"]


# ------------------------------------------------------------------ catalog
@dataclass
class SliceCatalog:
    """Fitted models + specs for every slice config (the fleet's Φ)."""

    model_cfg: object
    specs: list[SliceSpec]
    feed: RidgeModel
    start_warm: NormalModel
    start_cold: NormalModel
    comp_cloud: GBRT
    store: NormalModel
    comp_edge: RidgeModel
    store_edge: NormalModel
    cloud_comp_std_frac: float
    edge_comp_std_frac: float
    pricing: SlicePricing = field(default_factory=SlicePricing)


def llm_workload(n: int, rate_per_s: float = 1.0, seed: int = 0,
                 mean_tokens: float = 96.0) -> list[TaskInput]:
    """LLM request stream: Poisson arrivals, lognormal generation lengths."""

    def sampler(rng: np.random.Generator):
        toks = float(np.clip(rng.lognormal(np.log(mean_tokens), 0.6), 8, 16384))
        return toks, toks * 4.0  # ~4 payload bytes per token

    return PoissonWorkload(rate_per_s=rate_per_s, size_sampler=sampler,
                           seed=seed).generate(n)


def calibrate_catalog(model_cfg, specs: list[SliceSpec], *,
                      n_tasks: int = 24, n_cold: int = 2, seed: int = 0,
                      pricing: SlicePricing | None = None,
                      mean_tokens: float = 96.0, device=None) -> SliceCatalog:
    """Paper Sec. IV-C against real executions on ``device``: measure, fit,
    evaluate. Spans (when recording): ``calibrate`` over ``calibrate.cold``
    (the cold starts), ``calibrate.warm`` (the warm measurements) and
    ``calibrate.fit``."""
    with spans.span("calibrate"):
        rng = np.random.default_rng(seed)
        cloud_specs = [s for s in specs if not s.is_edge]
        pricing = pricing or SlicePricing()

        with spans.span("calibrate.cold"):
            # --- cold starts: real set-up cycles per config ----------------
            # warmup: the process's first cold start pays one-time backend
            # init (CUDA context, cuBLAS handles, kernel libraries) — not a
            # property of a slice cold start; burn it before measuring.
            warmup = LiveExecutor(cloud_specs[0], model_cfg, seed=99,
                                  device=device)
            warmup._ensure_compiled()
            warmup.evict()
            colds = []
            for s in cloud_specs:
                for i in range(n_cold):
                    ex = LiveExecutor(s, model_cfg, seed=100 + i,
                                      device=device)
                    start_ms, cold = ex._ensure_compiled()
                    assert cold
                    colds.append(start_ms)
                    ex.evict()
            start_cold = NormalModel.fit(np.array(colds))

        with spans.span("calibrate.warm"):
            # --- warm component measurements across (task, config) --------
            # calibration tasks must cover the serving size distribution
            # (paper Sec. IV-C trains on representative inputs)
            tok_samples = np.clip(
                rng.lognormal(np.log(mean_tokens), 0.6, n_tasks), 8, 16384)
            feats, comps, feeds, stores, warms = [], [], [], [], []
            edge_comps, edge_sizes, edge_stores = [], [], []
            warm_ex = {s.name: LiveExecutor(s, model_cfg, seed=7,
                                            device=device)
                       for s in cloud_specs}
            for ex in warm_ex.values():
                ex._ensure_compiled()
            edge_ex = LiveExecutor(EDGE_SPEC, model_cfg, device=device)
            edge_ex._ensure_compiled()

            for t in tok_samples:
                nb = float(t) * 4.0
                for s in cloud_specs:
                    rec = warm_ex[s.name].execute(int(t), nb)
                    feats.append([float(t), float(s.chips)])
                    comps.append(rec.comp_ms)
                    feeds.append((nb, rec.feed_ms))
                    stores.append(rec.store_ms)
                    warms.append(rec.start_ms)
                erec = edge_ex.execute(int(t), nb)
                edge_sizes.append(float(t))
                edge_comps.append(erec.comp_ms)
                edge_stores.append(erec.store_ms)
            # the measuring executors hold a model each: release them, so
            # that the serving pool builds its own on a card that holds only
            # a few at once
            for ex in (*warm_ex.values(), edge_ex):
                ex.evict()

        with spans.span("calibrate.fit"):
            feats = np.array(feats)
            comps = np.array(comps)
            comp_cloud = GBRT.fit(feats, comps,
                                  GBRTConfig(n_trees=60, max_depth=3,
                                             learning_rate=0.1))
            pred = comp_cloud.predict(feats)
            cloud_std = float(np.std((comps - pred) / np.maximum(pred, 1e-9)))

            feed = RidgeModel.fit(np.array([f[0] for f in feeds]),
                                  np.array([f[1] for f in feeds]))
            comp_edge = RidgeModel.fit(np.array(edge_sizes),
                                       np.array(edge_comps))
            epred = comp_edge.predict(np.array(edge_sizes))
            edge_std = float(np.std((np.array(edge_comps) - epred)
                                    / np.maximum(epred, 1e-9)))

            return SliceCatalog(
                model_cfg=model_cfg, specs=list(specs),
                feed=feed,
                start_warm=NormalModel.fit(np.array(warms)),
                start_cold=start_cold,
                comp_cloud=comp_cloud,
                store=NormalModel.fit(np.array(stores)),
                comp_edge=comp_edge,
                store_edge=NormalModel.fit(np.array(edge_stores)),
                cloud_comp_std_frac=cloud_std,
                edge_comp_std_frac=edge_std,
                pricing=pricing,
            )


def _edge_fleet_names(n_edge_devices: int) -> list[str]:
    """Device naming: the single-device fleet keeps the paper's ``edge``."""
    if n_edge_devices <= 1:
        return [EDGE]
    return [f"{EDGE}{i}" for i in range(n_edge_devices)]


def build_slice_predictor(cat: SliceCatalog, t_idl_ms: float = 120_000.0,
                          quantile: float | None = None,
                          n_edge_devices: int = 1) -> Predictor:
    cloud_targets = [
        SliceTarget(
            name=s.name, chips=s.chips,
            feed_model=cat.feed, start_warm=cat.start_warm,
            start_cold=cat.start_cold, comp_model=cat.comp_cloud,
            store_model=cat.store, pricing=cat.pricing,
            comp_std_frac=cat.cloud_comp_std_frac,
        )
        for s in cat.specs if not s.is_edge
    ]
    fleet = EdgeFleet([
        EdgeSliceTarget(comp_model=cat.comp_edge, store_model=cat.store_edge,
                        comp_std_frac=cat.edge_comp_std_frac, name=name)
        for name in _edge_fleet_names(n_edge_devices)
    ])
    return Predictor(cloud_targets=cloud_targets, edge_fleet=fleet,
                     cil=ContainerInfoList(t_idl_ms=t_idl_ms),
                     quantile=quantile)


# ------------------------------------------------------------- live backend
class LiveBackend:
    """ExecutionBackend over the real executor pool (paper Sec. VI-B analog).

    Every ``execute`` runs genuine model steps: cloud dispatches bill
    slice-seconds and may pay a real cold start; edge dispatches
    are free and queue on their device's single-slot FIFO executor — the pool
    may hold a whole fleet of edge executors, one per device name.
    """

    def __init__(self, pool: ExecutorPool, pricing: SlicePricing,
                 edge_name: str = EDGE, map_failures: bool = False,
                 detect_ms: float = 5.0):
        self.pool = pool
        self.pricing = pricing
        self.edge_name = edge_name
        # failure-aware serving contract (see ``repro_torch.core.faults``): with
        # ``map_failures`` on, a dispatch that raises comes back as a FAILED
        # ``ExecutionOutcome`` (transient, retryable) instead of propagating,
        # so ``PlacementRuntime``'s retry / failover / breaker loop drives
        # real executor errors exactly like the twin's injected ones. A
        # sticky CUDA error or a refused kernel launch is never mapped
        # (``is_cuda_error``): it would come back as a stream of "transient"
        # failures that hide the faulty kernel.
        self.map_failures = map_failures
        self.detect_ms = detect_ms

    @property
    def edge_names(self) -> tuple[str, ...]:
        return self.pool.edge_names

    def probe_cold(self, target: str, now: float) -> bool:
        return self.pool.probe_cold(target, now)

    def execute(self, task: TaskInput, target: str, now: float) -> ExecutionOutcome:
        if not self.map_failures:
            return self._execute_raw(task, target, now)
        try:
            return self._execute_raw(task, target, now)
        except Exception as e:
            if is_cuda_error(e):
                raise
            return ExecutionOutcome(
                latency_ms=self.detect_ms, cost=0.0, cold=False,
                completion_ms=now + self.detect_ms,
                failed=True, fail_kind=TRANSIENT)

    def _execute_raw(self, task: TaskInput, target: str,
                     now: float) -> ExecutionOutcome:
        if target in self.pool.edges:
            rec = self.pool.execute_edge(int(task.size), task.bytes, now,
                                         device=target)
            return ExecutionOutcome(latency_ms=rec.total_ms, cost=0.0,
                                    cold=False, completion_ms=now + rec.total_ms,
                                    queue_wait_ms=rec.queue_ms, exec_ms=rec.comp_ms)
        cold = self.pool.probe_cold(target, now)
        rec = self.pool.execute_cloud(target, int(task.size), task.bytes, now)
        chips = self.pool.specs[target].chips
        return ExecutionOutcome(latency_ms=rec.total_ms,
                                cost=self.pricing.cost(rec.comp_ms, chips),
                                cold=cold, completion_ms=now + rec.total_ms,
                                queue_wait_ms=rec.queue_ms,
                                exec_ms=rec.start_ms + rec.comp_ms)

    # ---------------------------------------------------- concurrent driver
    def execute_async(self, tasks: list[TaskInput], targets: list[str],
                      races: list[tuple[int, int]] | None = None,
                      ) -> ExecutionBatch:
        """Run the dispatch plan through the pool's REAL concurrent loop.

        One dispatcher thread per target (edge device / cloud config), so
        fleet executions genuinely overlap on the wall clock; completions
        land out of arrival order and the pool's lease/land bookkeeping
        absorbs them. ``races`` are hedge pairs — the losing leg is cancelled
        when it never started (its row comes back cancelled: zero cost,
        infinite latency, ignored by the runtime's merge) or drained when it
        did. Returns the same struct-of-arrays ``ExecutionBatch`` the twin
        produces, so the async serve path stays object-free.
        """
        n = len(tasks)
        plan = [_Dispatch(idx=i, target=tg, n_tokens=int(t.size),
                          payload_bytes=t.bytes, arrival_ms=t.arrival_ms,
                          task=t.idx)
                for i, (t, tg) in enumerate(zip(tasks, targets))]
        recs = self.pool.serve_concurrent(plan, races=races)
        out = ExecutionBatch(
            latency_ms=np.full(n, np.inf), cost=np.zeros(n),
            cold=np.zeros(n, dtype=bool), completion_ms=np.full(n, np.inf),
            queue_wait_ms=np.zeros(n), exec_ms=np.zeros(n),
            cancelled=np.zeros(n, dtype=bool))
        for i, (t, tg, rec) in enumerate(zip(tasks, targets, recs)):
            if rec is None:
                out.cancelled[i] = True
                continue
            out.latency_ms[i] = rec.total_ms
            out.completion_ms[i] = t.arrival_ms + rec.total_ms
            if tg in self.pool.edges:
                out.queue_wait_ms[i] = rec.queue_ms
                out.exec_ms[i] = rec.comp_ms
            else:
                chips = self.pool.specs[tg].chips
                out.cost[i] = self.pricing.cost(rec.comp_ms, chips)
                out.cold[i] = rec.cold
                out.exec_ms[i] = rec.start_ms + rec.comp_ms
        return out


def make_live_runtime(cat: SliceCatalog, policy: Policy,
                      t_idl_ms: float = 120_000.0,
                      quantile: float | None = None,
                      n_edge_devices: int = 1,
                      network: NetworkProfile | None = None,
                      retry: RetryPolicy | None = None,
                      admission: AdmissionPolicy | None = None,
                      breaker: CircuitBreaker | None = None,
                      device=None) -> PlacementRuntime:
    """Wire a calibrated catalog into the unified serve loop: catalog →
    Predictor → DecisionEngine → ``PlacementRuntime`` over a ``LiveBackend``.

    ``n_edge_devices > 1`` provisions a fleet of always-resident edge
    executors (named ``edge0..``), so the live prototype serves fleets with
    the same balancer-driven placement as the twin. The returned runtime
    exposes BOTH drivers: ``serve`` dispatches sequentially; ``serve_async``
    runs the pool's concurrent dispatch loop (one worker thread per edge
    device and per cloud config), overlapping real executions across the
    fleet. ``network`` switches on the emulated WAN legs (upload / IoT
    result-upload as real wall-clock waits) — the latency the async driver
    overlaps with compute.

    ``retry`` / ``admission`` / ``breaker`` switch on failure-aware serving
    (``repro_torch.core.faults``): real executor exceptions come back as failed,
    retryable outcomes and the runtime retries / fails over / sheds with the
    exact same driver the twin uses. The failure-aware live driver dispatches
    sequentially (the retry loop needs each outcome before scheduling the
    next attempt); use the plain runtime for maximum-overlap serving.

    ``device`` is where the executors and the Decision Engine run
    (``None``: the CUDA card). On the card the pool holds at most the
    models that fit (``executors.resident_capacity``, the edge fleet
    included; no cap on the CPU, as in the reference): at the cap a cloud
    dispatch that finds no idle container of its config queues on the
    virtual clock, behind the one of its config that frees first, else
    until the container that frees first is reclaimed
    (``ExecutorPool.reclaimed``), and the wait is part of its latency
    (``queue_wait_ms``). A card that holds only a few copies of a large
    model needs it: the decisions are made from predictions, and while a
    cold start is long against the arrival gaps the policy sends cold
    dispatches that would each provision another container."""
    edge_specs = [SliceSpec(name, chips=EDGE_SPEC.chips,
                            tokens_per_step=EDGE_SPEC.tokens_per_step,
                            is_edge=True)
                  for name in _edge_fleet_names(n_edge_devices)]
    pool = make_pool(cat.model_cfg, [s for s in cat.specs if not s.is_edge],
                     t_idl_ms=t_idl_ms, edge_specs=edge_specs, network=network,
                     device=device)
    predictor = build_slice_predictor(cat, t_idl_ms=t_idl_ms, quantile=quantile,
                                      n_edge_devices=n_edge_devices)
    engine = DecisionEngine(predictor=predictor, policy=policy, edge_name=EDGE,
                            device=device)
    backend = LiveBackend(pool, cat.pricing,
                          map_failures=retry is not None or breaker is not None)
    return PlacementRuntime(engine=engine, backend=backend, retry=retry,
                            admission=admission, breaker=breaker)


def is_cuda_error(e: BaseException) -> bool:
    """A CUDA error that must stop the serve: ``torch.AcceleratorError`` (a
    sticky device error, such as an illegal address) or a kernel of the port
    that could not be built or launched (``_build.KernelLaunchError``).
    ``LiveBackend`` re-raises these instead of mapping them to a transient
    failure. An out-of-memory error is not one of them: the allocator
    recovers from it, so it stays mapped, as in the reference."""
    return isinstance(e, (torch.AcceleratorError, KernelLaunchError))


# --------------------------------------------------------------- live server
class LivePlacementServer:
    """The live prototype: real placement over real executions (Table V).

    Deprecated: thin wrapper over ``make_live_runtime`` — the serve loop is
    ``repro_torch.core.runtime.PlacementRuntime``, shared with the simulator.
    """

    def __init__(self, cat: SliceCatalog, policy: Policy,
                 t_idl_ms: float = 120_000.0, quantile: float | None = None,
                 device=None):
        self.cat = cat
        self.runtime = make_live_runtime(cat, policy, t_idl_ms=t_idl_ms,
                                         quantile=quantile, device=device)
        # back-compat aliases
        self.pool = self.runtime.backend.pool
        self.predictor = self.runtime.engine.predictor
        self.engine = self.runtime.engine

    def serve(self, tasks: list[TaskInput], batched: bool = True) -> SimulationResult:
        return self.runtime.serve(tasks, batched=batched)
