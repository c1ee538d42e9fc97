"""The Decision Engine (paper Sec. III-B, V-B, Alg. 1) — with a columnar core.

``Policy`` is the formal contract every placement policy implements:

- ``choose(preds, edge_name)`` picks a target from per-target predictions;
- ``constraints()`` exposes the policy's declarative constraints
  (``PolicyConstraints``: deadline and/or per-task budget) so the runtime can
  report the right metrics without inspecting policy internals;
- ``hedge(preds, chosen, allowed, edge_name)`` is a first-class hook for
  duplicate dispatch: a policy may nominate a backup target after ``choose``;
- ``observe(chosen)`` feeds the decision back into policy state (Alg. 1's
  surplus bank).

Two placement policies from the paper:

- ``MinCostPolicy(deadline_ms)``: minimize execution cost subject to a per-task
  end-to-end deadline δ. Feasible set M = targets whose *predicted* latency
  (edge latency includes predicted FIFO queue wait) meets δ; pick the cheapest.
  If M is empty, the task is queued on the edge to save cost (paper Sec. V-B).

- ``MinLatencyPolicy(c_max, alpha)``: minimize latency subject to a per-task
  budget C(k) ≤ C_max + α·surplus(k), where surplus(k) = Σ_{i<k}(C_max − C(i))
  is the banked unused budget (paper Eqn. 4, Alg. 1). The edge costs $0, so M
  is never empty and surplus never goes negative.

Beyond-paper extension: ``HedgedPolicy`` wraps MinLatency and duplicates the
dispatch to a second config when the predicted tail latency of the primary
exceeds a hedging threshold (classic tail-at-scale hedging; evaluated in
benchmarks as a beyond-paper experiment). It implements the ``hedge`` hook,
so composition is explicit — no engine-side introspection.

``DecisionEngine.place()`` handles one task; ``DecisionEngine.place_many()``
is the batched path. For the paper policies (exactly ``MinCostPolicy`` /
``MinLatencyPolicy``) it runs the COLUMNAR core: policy ``choose`` becomes a
masked lexicographic argmin over the ``(n_tasks, n_targets)`` prediction
arrays, the balancer becomes an argmin over per-device wait arrays, and the
three sequential recurrences that couple consecutive decisions — the surplus
bank, the CIL warm/cold feedback, and the predicted edge-queue horizons — run
speculate-and-repair: assume the speculated placements hold for a chunk,
recompute every induced state trajectory exactly (segment cumsums, event
walks), find the first decision the exact state would change, repair there,
resume. Decisions are BIT-IDENTICAL to the per-task ``step`` path; hedged or
custom policies/balancers fall back to the per-task walk automatically. The
result is a struct-of-arrays ``DecisionBatch`` (lazy ``PlacementDecision``
views) that flows straight into the vectorized execution backends.

Fleet placement: when the Predictor carries a multi-device ``EdgeFleet``, an
``EdgeBalancer`` first nominates ONE device to stand in as "the edge" for the
policy (the paper's policies are defined against a single λ_edge), from the
per-device predicted queue waits. ``LeastPredictedWaitBalancer`` is the
default; ``RoundRobinBalancer``/``RandomBalancer`` are the classic baselines
it is benchmarked against. The engine then runs the unchanged paper policy
over {cloud configs} ∪ {nominated device}.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Callable, Iterator, Mapping, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.cil import ContainerInfoList
from repro_torch.core.predictor import EDGE as EDGE_NAME
from repro_torch.core.predictor import Prediction, PredictionBatch, Predictor
from repro_torch.core.recurrence import horizon_before, surplus_trajectory
from repro_torch.core.workload import task_arrays

# Columnar speculate-and-repair tuning — all correctness-neutral (only wall
# time changes): the max/min speculation span (the span tracks a few multiples
# of the observed accept-run EMA, so repair cost stays proportional to how far
# speculation actually reaches); the run length below which speculation is
# judged losing (tight edge/cloud oscillation) and the scalar-on-arrays loop
# decides a stretch instead; and the minimum such stretch.
COLUMNAR_CHUNK = 4096
COLUMNAR_MIN_CHUNK = 128
COLUMNAR_MIN_RUN = 24
COLUMNAR_WALK_STRETCH = 512
ARRAY_BACKENDS = ("numpy", "torch")


@dataclass(frozen=True)
class PolicyConstraints:
    """Declarative constraints a policy enforces (``None`` = unconstrained)."""

    deadline_ms: float | None = None
    c_max: float | None = None


@dataclass(frozen=True)
class PlacementDecision:
    task_idx: int
    target: str
    prediction: Prediction
    feasible: bool  # False when min-cost fell back to the edge queue
    allowed_cost: float  # budget in force at decision time (min-latency)
    hedge_target: str | None = None
    hedge_prediction: Prediction | None = None
    edge_device: str | None = None  # the balancer's nominated edge device


class Policy(abc.ABC):
    """The placement-policy contract consumed by ``DecisionEngine``."""

    @abc.abstractmethod
    def constraints(self) -> PolicyConstraints:
        """The constraints this policy enforces, for result reporting."""

    @abc.abstractmethod
    def choose(self, preds: dict[str, Prediction],
               edge_name: str = EDGE_NAME) -> tuple[str, bool, float]:
        """Pick a target. Returns (name, feasible, allowed_cost)."""

    def hedge(self, preds: dict[str, Prediction], chosen: str, allowed: float,
              edge_name: str = EDGE_NAME) -> tuple[str, Prediction] | None:
        """Optional backup dispatch for the decision just made by ``choose``.

        Called by the engine immediately after ``choose``; returns
        ``(backup_name, backup_prediction)`` or ``None``. The default policy
        never hedges.
        """
        return None

    @abc.abstractmethod
    def observe(self, chosen: Prediction) -> None:
        """Feed the chosen prediction back into policy state."""


class MinCostPolicy(Policy):
    """Minimize cost s.t. per-task deadline δ."""

    def __init__(self, deadline_ms: float):
        self.deadline_ms = deadline_ms

    def constraints(self) -> PolicyConstraints:
        return PolicyConstraints(deadline_ms=self.deadline_ms)

    def choose(self, preds: dict[str, Prediction], edge_name: str = EDGE_NAME):
        feasible = {n: p for n, p in preds.items() if p.latency_ms <= self.deadline_ms}
        if not feasible:
            # No configuration satisfies the deadline: queue on the edge to
            # save cost (paper Sec. V-B).
            return edge_name, False, float("inf")
        name = min(feasible, key=lambda n: (feasible[n].cost, feasible[n].latency_ms))
        return name, True, float("inf")

    def observe(self, chosen: Prediction) -> None:  # stateless
        pass


class MinLatencyPolicy(Policy):
    """Minimize latency s.t. cost ≤ C_max + α·surplus (Alg. 1)."""

    def __init__(self, c_max: float, alpha: float = 0.0):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0,1], got {alpha}")
        self.c_max = c_max
        self.alpha = alpha
        self.surplus = 0.0

    @property
    def allowed(self) -> float:
        return self.c_max + self.alpha * self.surplus

    def constraints(self) -> PolicyConstraints:
        return PolicyConstraints(c_max=self.c_max)

    def choose(self, preds: dict[str, Prediction], edge_name: str = EDGE_NAME):
        allowed = self.allowed
        feasible = {n: p for n, p in preds.items() if p.cost <= allowed}
        # λ_edge costs 0, so feasible is never empty when an edge target exists.
        if not feasible:
            feasible = {edge_name: preds[edge_name]} if edge_name in preds else preds
        name = min(feasible, key=lambda n: (feasible[n].latency_ms, feasible[n].cost))
        return name, True, allowed

    def observe(self, chosen: Prediction) -> None:
        # Line 9 of Alg. 1: surplus accumulates the *predicted* unused budget.
        self.surplus += self.c_max - chosen.cost


class HedgedPolicy(Policy):
    """Beyond-paper: hedge high-tail-risk placements with a backup dispatch.

    Wraps MinLatencyPolicy. If the chosen target's predicted latency exceeds
    ``hedge_threshold_ms`` and a second, faster-on-tail config fits the
    *remaining* budget, a duplicate dispatch is issued; the effective latency
    is the min of the two (first-completion-wins). The hedge's cost draws down
    the surplus bank, so hedging can never spend budget the policy has not
    earned.
    """

    def __init__(self, inner: MinLatencyPolicy, hedge_threshold_ms: float):
        self.inner = inner
        self.hedge_threshold_ms = hedge_threshold_ms
        self.last_hedge: tuple[str, Prediction] | None = None

    @property
    def surplus(self) -> float:
        return self.inner.surplus

    @property
    def allowed(self) -> float:
        return self.inner.allowed

    def constraints(self) -> PolicyConstraints:
        return self.inner.constraints()

    def choose(self, preds: dict[str, Prediction], edge_name: str = EDGE_NAME):
        name, feasible, allowed = self.inner.choose(preds, edge_name)
        self.last_hedge = None
        primary = preds[name]
        if primary.latency_ms > self.hedge_threshold_ms:
            remaining = allowed - primary.cost
            candidates = {
                n: p for n, p in preds.items()
                if n != name and p.cost <= remaining and p.latency_ms < primary.latency_ms * 1.5
            }
            if candidates:
                backup = min(candidates, key=lambda n: candidates[n].latency_ms)
                self.last_hedge = (backup, candidates[backup])
        return name, feasible, allowed

    def hedge(self, preds: dict[str, Prediction], chosen: str, allowed: float,
              edge_name: str = EDGE_NAME) -> tuple[str, Prediction] | None:
        return self.last_hedge

    def observe(self, chosen: Prediction) -> None:
        self.inner.observe(chosen)
        if self.last_hedge is not None:
            # the hedge's cost also draws down the budget bank
            self.inner.surplus -= self.last_hedge[1].cost


@dataclass
class PredictedEdgeQueue:
    """The Decision Engine's shadow of one single-slot edge FIFO queue.

    The framework never sees the edge's *actual* queue; it advances a
    predicted busy-horizon with each predicted compute time it sends there
    (paper Sec. V-B). Shared by the step-wise and batched decision loops;
    fleets keep one of these per device.
    """

    horizon_ms: float = 0.0

    def wait_ms(self, now: float) -> float:
        return max(self.horizon_ms - now, 0.0)

    def push(self, now: float, comp_ms: float) -> None:
        self.horizon_ms = max(self.horizon_ms, now) + comp_ms


# ------------------------------------------------------------- edge balancing
class EdgeBalancer(abc.ABC):
    """Nominates ONE fleet device to stand in as "the edge" for the policy."""

    @abc.abstractmethod
    def pick(self, names: Sequence[str], waits: Mapping[str, float],
             preds: Mapping[str, Prediction]) -> str:
        """Pick a device name. ``names`` is the fleet order; ``waits`` maps
        device → predicted FIFO queue wait (ms); ``preds`` holds the full
        per-target predictions for richer strategies."""


class LeastPredictedWaitBalancer(EdgeBalancer):
    """Default: the device with the smallest predicted queue wait (ties break
    by fleet order, so a single-device fleet reduces to the paper exactly).

    On the columnar path this is ``argmin`` over the per-device wait arrays
    (``np.argmin`` returns the first minimum — the same fleet-order
    tie-break)."""

    def pick(self, names, waits, preds):
        return min(names, key=lambda n: waits.get(n, 0.0))


class RoundRobinBalancer(EdgeBalancer):
    """Classic baseline: cycle through devices regardless of backlog."""

    def __init__(self):
        self._i = 0

    def pick(self, names, waits, preds):
        name = names[self._i % len(names)]
        self._i += 1
        return name


class RandomBalancer(EdgeBalancer):
    """Classic baseline: uniform random device (deterministic per seed)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def pick(self, names, waits, preds):
        return names[int(self.rng.integers(len(names)))]


def failover_choice(policy: Policy, preds: Mapping[str, "Prediction"],
                    exclude: "set[str] | frozenset[str]",
                    edge_names: Sequence[str],
                    waits: Mapping[str, float],
                    ) -> "tuple[str, Prediction] | None":
    """Next-best surviving target after a failed dispatch: re-enter the
    placement path with the failed/tried/tripped targets masked out.

    Mirrors ``DecisionEngine._decide`` exactly — the surviving fleet device
    with the least predicted wait stands in as "the edge" for the policy,
    which then chooses over the cloud configs plus that device — but WITHOUT
    the ``observe``/CIL side effects: the failure-aware runtime applies the
    failover's state accounting itself (surplus drawdown like a hedge leg,
    ``update_cil`` for the extra container). Returns ``None`` when no target
    survives the mask (the task fails permanently).
    """
    view = {n: p for n, p in preds.items() if n not in exclude}
    if not view:
        return None
    edges = [n for n in edge_names if n in view]
    if edges:
        edge_choice = min(edges, key=lambda n: waits.get(n, 0.0))
        policy_view = {n: p for n, p in view.items()
                       if n == edge_choice or n not in edges}
    else:
        edge_choice = next(iter(view))  # no surviving edge: cloud-only view
        policy_view = view
    name, _feasible, _allowed = policy.choose(policy_view, edge_choice)
    if name not in view:
        return None  # the policy's edge fallback is itself masked out
    return name, view[name]


_POLICY_METHODS = ("choose", "observe", "constraints", "hedge")
# Policies whose choose/observe the columnar kernels replicate exactly.
# Subclasses are NOT eligible (they may override behavior) — exact type only.
_COLUMNAR_POLICIES = (MinCostPolicy, MinLatencyPolicy)
_COLUMNAR_BALANCERS = (LeastPredictedWaitBalancer, RoundRobinBalancer,
                       RandomBalancer)


@dataclass(eq=False)
class DecisionBatch(Sequence):
    """Struct-of-arrays placement decisions (the columnar ``place_many`` path).

    ``target_codes`` indexes ``names`` = cloud targets (predictor order) then
    fleet devices (fleet order); codes ≥ ``n_cloud`` are edge placements.
    Indexing/iterating materializes lazy ``PlacementDecision`` views (the
    columnar policies never hedge, so views carry no hedge); the vectorized
    runtime consumes the arrays directly and never builds a view.

    ``batch`` may be ``None`` when the decisions came from the device-resident
    torch core, which never runs the host prediction pass — ``batch_factory``
    then rebuilds the ``PredictionBatch`` on first view access (only per-task
    consumers pay it; the vectorized runtime reads arrays only).
    """

    batch: PredictionBatch | None   # source predictions, for lazy components
    names: tuple[str, ...]
    n_cloud: int
    task_idx: np.ndarray            # (n,) int64
    target_codes: np.ndarray        # (n,) int64
    latency_ms: np.ndarray          # chosen predicted latency
    cost: np.ndarray                # chosen predicted cost
    cold: np.ndarray                # chosen predicted cold (bool)
    comp_ms: np.ndarray             # chosen predicted compute
    queue_wait_ms: np.ndarray       # predicted wait of the chosen edge device
    feasible: np.ndarray            # bool
    allowed_cost: np.ndarray
    edge_device_codes: np.ndarray | None  # (n,) device idx, None = no fleet
    batch_factory: "Callable[[], PredictionBatch] | None" = None

    def __len__(self) -> int:
        return self.target_codes.shape[0]

    def __bool__(self) -> bool:
        return len(self) > 0

    @property
    def targets(self) -> np.ndarray:
        """Chosen target names as an object array (diagnostics)."""
        return np.array(self.names, dtype=object)[self.target_codes]

    def target_list(self) -> list[str]:
        """Chosen target names as a plain list (what ``execute_many`` eats)."""
        table = list(self.names)
        return [table[c] for c in self.target_codes.tolist()]

    def rows_by_target(self) -> dict[str, np.ndarray]:
        """Row indices per chosen target, in arrival order — the partition
        the async runners' per-target workers serve (each runner derives its
        own copy inline from ``target_codes``; this is the inspection view
        for tests, examples, and fan-out diagnostics). Concatenating the
        queues back by row index recovers the batch."""
        return {self.names[c]: np.nonzero(self.target_codes == c)[0]
                for c in np.unique(self.target_codes).tolist()}

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = int(i)
        if self.batch is None:
            if self.batch_factory is None:
                raise RuntimeError(
                    "DecisionBatch carries no PredictionBatch (device-resident "
                    "placement) and no batch_factory to rebuild one; per-task "
                    "views are unavailable")
            self.batch = self.batch_factory()
        code = int(self.target_codes[i])
        name = self.names[code]
        if code >= self.n_cloud:
            tb = self.batch.edges[name]
            comps = {k: float(v[i]) for k, v in tb.warm.items()}
            comps["queue"] = float(self.queue_wait_ms[i])
        else:
            tb = self.batch.cloud[name]
            src = tb.cold if self.cold[i] else tb.warm
            comps = {k: float(v[i]) for k, v in src.items()}
        pred = Prediction(target=name, latency_ms=float(self.latency_ms[i]),
                          cost=float(self.cost[i]), cold=bool(self.cold[i]),
                          components=comps)
        device = None
        if self.edge_device_codes is not None:
            d = int(self.edge_device_codes[i])
            device = self.names[self.n_cloud + d] if d >= 0 else None
        return PlacementDecision(
            task_idx=int(self.task_idx[i]), target=name, prediction=pred,
            feasible=bool(self.feasible[i]),
            allowed_cost=float(self.allowed_cost[i]), edge_device=device)

    def __iter__(self) -> Iterator[PlacementDecision]:
        for i in range(len(self)):
            yield self[i]


def _warm_any(busy: np.ndarray, last: np.ndarray, t_idl: float,
              times: np.ndarray) -> np.ndarray:
    """Vectorized CIL warm probe: is any container idle-and-unexpired at each
    query time? (``busy ≤ t ≤ last + t_idl`` — the ``will_warm_start`` test.)"""
    if busy.shape[0] == 0:
        return np.zeros(times.shape[0], dtype=bool)
    t = times[:, None]
    return ((busy[None, :] <= t) & (t <= last[None, :] + t_idl)).any(axis=1)


class _ColumnarContext:
    """Shared arrays + running exact state for one columnar ``place_many``."""

    def __init__(self, engine: "DecisionEngine", tasks: list,
                 batch: PredictionBatch, edge_queues: dict):
        self.engine = engine
        self.batch = batch
        self.cloud_names = list(batch.cloud)
        self.dev_names = list(batch.edges)
        self.n_cloud = len(self.cloud_names)
        self.n_dev = len(self.dev_names)
        self.has_edge = self.n_dev > 0
        self.T = self.n_cloud + (1 if self.has_edge else 0)
        self.edge_col = self.T - 1 if self.has_edge else -1
        self.task_idx, self.nows, _, _ = task_arrays(tasks, "ia")
        self.cwarm = [batch.cloud[nm].warm_latency for nm in self.cloud_names]
        self.ccold = [batch.cloud[nm].cold_latency for nm in self.cloud_names]
        self.ccost = [batch.cloud[nm].cost for nm in self.cloud_names]
        self.ccomp = [batch.cloud[nm].warm["comp"] for nm in self.cloud_names]
        if self.has_edge:
            self.e_lat = np.stack(
                [batch.edges[nm].warm_latency for nm in self.dev_names], axis=1)
            self.e_cost = np.stack(
                [batch.edges[nm].cost for nm in self.dev_names], axis=1)
            self.e_comp = np.stack(
                [batch.edges[nm].warm["comp"] for nm in self.dev_names], axis=1)
        # running exact state
        self.queues = edge_queues  # device name -> PredictedEdgeQueue
        self.cil: ContainerInfoList = engine.predictor.cil
        self.t_idl = self.cil.t_idl_ms
        policy = engine.policy
        self.is_minlat = type(policy) is MinLatencyPolicy


class DecisionEngine:
    """Binds a Predictor to a placement policy; one ``place()`` call per input.

    With a multi-device edge fleet, ``balancer`` nominates the device the
    policy sees as "the edge" (default: least predicted queue wait).
    ``edge_name`` survives as the deprecated single-device convenience — it is
    only consulted when the Predictor carries no edge fleet at all.

    ``record_decisions`` is OFF by default: a long-running serve would
    otherwise accumulate every ``PlacementDecision`` forever. Turn it on to
    audit the decision stream through ``engine.decisions``.

    ``columnar`` gates the vectorized ``place_many`` core (see module
    docstring); with it off — or with a policy/balancer the kernels cannot
    replicate, or out-of-order arrival times — ``place_many`` runs the
    per-task walk over the same batched predictions. ``columnar_stats``
    reports the last columnar run's speculate-and-repair behavior:
    ``{"chunks": speculation segments opened, "repairs": mispredicted
    decisions repaired, "walked": rows decided by the scalar-on-arrays
    fallback, "n": batch size}``.

    ``array_backend`` selects the chunk pipeline implementation:
    ``"numpy"`` (the oracle) or ``"torch"`` (the device placement core
    ``repro_torch.core.torch_core`` on ``device``: bit-identical to numpy on
    the CPU, decision-identical with floats within 1e-9 on the card).
    Anything the torch core cannot replicate (hedged/custom policies,
    quantile prediction, out-of-order arrivals, ``record_decisions``, custom
    target/model types) takes the numpy path, chunk by chunk, and is counted
    in ``fallback_chunks``.

    ``device`` is where the engine computes: ``None`` means the CUDA card and
    raises without one; ``device="cpu"`` asks for the CPU (see
    ``repro_torch.resolve_device``). The engine hands it to its Predictor, so
    the numpy path's batched GBRT column also runs on the card.
    """

    def __init__(self, predictor: Predictor, policy: Policy,
                 edge_name: str = EDGE_NAME,
                 balancer: EdgeBalancer | None = None,
                 record_decisions: bool = False,
                 columnar: bool = True,
                 array_backend: str = "numpy",
                 device=None):
        self.predictor = predictor
        self.policy = policy
        self.edge_name = edge_name
        self.balancer = balancer if balancer is not None \
            else LeastPredictedWaitBalancer()
        self.record_decisions = record_decisions
        self.columnar = columnar
        if array_backend not in ARRAY_BACKENDS:
            raise ValueError(
                f"array_backend must be 'numpy' or 'torch', "
                f"got {array_backend!r}")
        self.array_backend = array_backend
        self.device = resolve_device(device)
        predictor.device = self.device
        self.fallback_chunks = 0  # torch-backend chunks that ran on numpy
        self.decisions: list[PlacementDecision] = []
        self.columnar_stats: dict | None = None
        # the speculate-and-repair accept-run EMA, persisted across
        # ``place_many`` calls so a chunked stream resumes speculation at the
        # span the workload has already earned instead of re-slow-starting
        # every chunk (correctness-neutral: only wall time changes)
        self._spec_ema: float | None = None
        missing = [m for m in _POLICY_METHODS if not hasattr(self.policy, m)]
        if missing:
            raise TypeError(
                f"{type(self.policy).__name__} does not implement the Policy "
                f"protocol (missing {', '.join(missing)}); subclass "
                "repro_torch.core.decision.Policy")
        names = self.edge_names
        if len(names) == 1:
            self.edge_name = names[0]

    @property
    def edge_names(self) -> tuple[str, ...]:
        """Fleet device names (empty when the Predictor has no edge)."""
        return self.predictor.edge_names

    def _sync_device_state(self) -> None:
        """Materialize any device-resident stream state before a host-side
        read/mutation of CIL / surplus / horizons (no-op when none held)."""
        _tc = self.__dict__.get("_torch_core_cache")
        if _tc is not None and _tc[1] is not None:
            _tc[1].sync_host("fallback")

    def place(self, task, now: float, edge_queue_wait_ms: float = 0.0,
              edge_waits: Mapping[str, float] | None = None) -> PlacementDecision:
        self._sync_device_state()
        waits = (dict(edge_waits) if edge_waits is not None
                 else {n: edge_queue_wait_ms for n in self.edge_names})
        preds = self.predictor.predict(task, now, edge_waits=waits)
        return self._decide(task, now, preds, waits)

    def place_many(self, tasks: list,
                   edge_queue: PredictedEdgeQueue | None = None,
                   edge_queues: dict[str, PredictedEdgeQueue] | None = None,
                   ) -> "DecisionBatch | list[PlacementDecision]":
        """Batched placement: one vectorized prediction pass over all tasks ×
        targets, then the columnar decision core (paper policies) or the
        per-task policy/CIL/edge-queue walk (hedged/custom policies).

        Decisions are bit-identical to a ``place()`` loop either way. The
        columnar path returns a struct-of-arrays ``DecisionBatch`` (iterable
        as lazy ``PlacementDecision`` views); the walk returns the familiar
        list. See ``benchmarks/bench_runtime.py`` for the throughput gap.

        ``edge_queues`` maps device → ``PredictedEdgeQueue`` (one per fleet
        device, created fresh when omitted); ``edge_queue`` is the deprecated
        single-device spelling.
        """
        names = self.edge_names
        if edge_queues is None:
            if edge_queue is not None:
                if len(names) != 1:
                    raise ValueError(
                        "edge_queue is single-device only; pass edge_queues "
                        f"for a {len(names)}-device fleet")
                edge_queues = {names[0]: edge_queue}
            else:
                edge_queues = {n: PredictedEdgeQueue() for n in names}
        # device-resident route, BEFORE the (expensive) host prediction pass
        # it exists to avoid; record_decisions stays on the numpy path (its
        # views would rebuild the prediction batch anyway)
        if tasks and self.array_backend == "torch":
            if self.columnar and not self.record_decisions \
                    and self._columnar_eligible():
                from repro_torch.core import torch_core

                core = torch_core.core_for(self)
                if core is not None:
                    out = core.place_chunk(self, tasks, edge_queues)
                    if out is not None:
                        return out
            self.fallback_chunks += 1
        # fallback (hedged/custom policy, record_decisions, force-walk, core
        # refusal): the host paths below read CIL/surplus/horizons, so any
        # device-resident stream state must land first — place_chunk syncs
        # on its own refusals; this covers routes that never reached it
        self._sync_device_state()
        batch = self.predictor.predict_batch(tasks)
        if tasks and self.columnar and self._columnar_eligible():
            out = self._place_columnar(tasks, batch, edge_queues)
            if out is not None:
                if self.record_decisions:
                    self.decisions.extend(out)
                return out
        return self._place_walk(tasks, batch, edge_queues)

    def _place_walk(self, tasks, batch, edge_queues) -> list[PlacementDecision]:
        """The per-task decision walk over batched predictions (fallback)."""
        out = []
        for i, task in enumerate(tasks):
            now = task.arrival_ms
            waits = {n: q.wait_ms(now) for n, q in edge_queues.items()}
            preds = self.predictor.predict_at(batch, i, now, edge_waits=waits)
            d = self._decide(task, now, preds, waits)
            if d.target in edge_queues:
                edge_queues[d.target].push(now, d.prediction.comp_ms)
            if d.hedge_target is not None and d.hedge_target in edge_queues \
                    and d.hedge_prediction is not None:
                edge_queues[d.hedge_target].push(now, d.hedge_prediction.comp_ms)
            out.append(d)
        return out

    # --------------------------------------------------------- columnar core
    def _columnar_eligible(self) -> bool:
        """Can the vectorized kernels replicate this engine bit-for-bit?

        Exact-type checks only: a subclass may override ``choose``/``pick``/
        CIL semantics, and the contract is bit-parity with the step path —
        anything the kernels don't provably replicate takes the walk.
        """
        if type(self.policy) not in _COLUMNAR_POLICIES:
            return False
        if type(self.policy) is MinCostPolicy and not self.edge_names:
            return False  # all-infeasible would KeyError mid-run on the walk
        if type(self.predictor) is not Predictor:
            return False
        if type(self.predictor.cil) is not ContainerInfoList:
            return False
        if len(self.edge_names) > 1 \
                and type(self.balancer) not in _COLUMNAR_BALANCERS:
            return False
        return True

    def _place_columnar(self, tasks, batch, edge_queues) -> DecisionBatch | None:
        ctx = _ColumnarContext(self, tasks, batch, edge_queues)
        n = batch.n
        policy = self.policy
        if not ctx.has_edge and type(policy) is MinLatencyPolicy \
                and not ctx.cloud_names:
            return None  # nothing to choose from — let the walk raise
        if n > 1 and not bool(np.all(np.diff(ctx.nows) >= 0.0)):
            # Out-of-order arrivals: the walk's per-task cil.reap(now) at a
            # far-future task PERMANENTLY drops expired containers before
            # earlier-timed tasks are decided, which the columnar snapshot
            # cannot replicate without replaying every reap — take the walk
            # (all shipped workload generators emit sorted arrivals).
            return None

        # balancer nominations: wait-independent balancers are one precomputed
        # sequence (they never cause a repair); least-predicted-wait is the
        # argmin over the induced wait arrays inside each pass.
        nom_fixed: np.ndarray | None = None
        if ctx.n_dev == 1:
            nom_fixed = np.zeros(n, dtype=np.int64)
        elif ctx.n_dev > 1:
            bal = self.balancer
            if type(bal) is RoundRobinBalancer:
                nom_fixed = (bal._i + np.arange(n, dtype=np.int64)) % ctx.n_dev
                bal._i += n
            elif type(bal) is RandomBalancer:
                # one block draw == n scalar draws on numpy Generators
                nom_fixed = bal.rng.integers(ctx.n_dev, size=n).astype(np.int64)
        ctx.nom_fixed = nom_fixed

        out_code = np.empty(n, dtype=np.int64)
        out_lat = np.empty(n)
        out_cost = np.empty(n)
        out_cold = np.zeros(n, dtype=bool)
        out_comp = np.empty(n)
        out_wait = np.zeros(n)
        out_feas = np.ones(n, dtype=bool)
        out_allowed = np.full(n, np.inf)
        out_dev = np.full(n, -1, dtype=np.int64) if ctx.has_edge else None

        out = (out_code, out_lat, out_cost, out_cold, out_comp, out_wait,
               out_feas, out_allowed, out_dev)
        # Run-length-adaptive speculation: a repair costs one pass over the
        # remaining span, so the span tracks a few multiples of the observed
        # accept-run length (EMA). When runs collapse below COLUMNAR_MIN_RUN
        # — tight edge/cloud oscillation where almost every choice depends on
        # the immediately preceding one — speculation cannot pay, and the
        # scalar-on-arrays loop decides a stretch before speculation retries.
        # slow-start the span: clean regimes double their way up to the full
        # chunk within a few segments, while oscillating regimes never pay a
        # full-chunk pass per repair. A chunked stream resumes from the EMA
        # the previous chunk converged to (see ``_spec_ema``).
        if self._spec_ema is not None:
            run_ema = self._spec_ema
            span = min(float(COLUMNAR_CHUNK),
                       max(float(COLUMNAR_MIN_CHUNK), 8.0 * run_ema))
        else:
            run_ema = float(COLUMNAR_WALK_STRETCH // 8)
            span = 8.0 * run_ema
        repairs_streak = 0
        inner = 0
        end = 0
        guess_code = None  # speculated policy choices for rows [inner, end)
        stats = {"chunks": 0, "repairs": 0, "walked": 0, "n": n}
        while inner < n:
            if repairs_streak >= 3 and run_ema < COLUMNAR_MIN_RUN:
                stretch = min(n, inner + max(COLUMNAR_WALK_STRETCH, int(span)))
                self._cw_scalar_rows(ctx, inner, stretch, out)
                stats["walked"] += stretch - inner
                inner = stretch
                guess_code = None
                repairs_streak = 0
                run_ema = float(COLUMNAR_MIN_RUN)  # neutral: re-measure
                continue
            if guess_code is None:
                # open a speculation segment with the frozen-state guess
                end = min(n, inner + max(COLUMNAR_MIN_CHUNK, int(span)))
                guess_code = self._cw_pass(ctx, inner, end, None)["code"]
                stats["chunks"] += 1
            res = self._cw_pass(ctx, inner, end, guess_code)
            code = res["code"]
            # only the policy choice is speculative: balancer nominations are
            # computed EXACTLY from the speculated edge/cloud pattern, so a
            # matching choice prefix implies a fully exact prefix
            hit = np.nonzero(code != guess_code)[0]
            a = (int(hit[0]) + 1) if hit.size else (end - inner)
            self._cw_accept(ctx, res, inner, a, out)
            inner += a
            run_ema = 0.7 * run_ema + 0.3 * a
            span = min(float(COLUMNAR_CHUNK),
                       max(float(COLUMNAR_MIN_CHUNK), 8.0 * run_ema))
            if hit.size:
                repairs_streak += 1
                stats["repairs"] += 1
                # the corrected tail is the best available guess for the rest
                # of the segment (exact until state next diverges); a repair
                # on the segment's last row leaves nothing to re-verify
                guess_code = code[a:].copy() if inner < end else None
            else:
                repairs_streak = 0
                guess_code = None
        # the walk reaps the CIL at every task's predict; one final reap at
        # the last arrival leaves the identical observable end state
        ctx.cil.reap(float(ctx.nows[-1]))
        self.columnar_stats = stats
        self._spec_ema = run_ema
        return DecisionBatch(
            batch=batch,
            names=tuple(ctx.cloud_names) + tuple(ctx.dev_names),
            n_cloud=ctx.n_cloud,
            task_idx=ctx.task_idx,
            target_codes=out_code,
            latency_ms=out_lat, cost=out_cost, cold=out_cold, comp_ms=out_comp,
            queue_wait_ms=out_wait, feasible=out_feas, allowed_cost=out_allowed,
            edge_device_codes=out_dev,
        )

    def _cw_pass(self, ctx: _ColumnarContext, lo: int, hi: int, spec_code):
        """One vectorized decision pass over rows [lo, hi).

        ``spec_code=None`` is the frozen-state speculation that opens a window
        (state at ``lo`` assumed to hold throughout); an array is a
        verification pass: the three recurrences are replayed EXACTLY under
        the speculated policy choices (segment cumsums for the surplus bank,
        the least-wait assignment walk / segment cumsums for the edge
        horizons, an event walk for the CIL), and the decisions are recomputed
        from that induced state. The first row where they disagree with the
        speculation is where the caller repairs. Balancer nominations are
        *derived* from the speculated edge/cloud pattern, never speculated
        themselves — so a matching choice prefix is a fully exact prefix.
        """
        r = hi - lo
        nows = ctx.nows[lo:hi]

        # --- edge horizons (before each row), nominations, induced waits ----
        HB = None
        nom = None
        ew = None
        if ctx.has_edge:
            if spec_code is not None and ctx.nom_fixed is None and ctx.n_dev > 1:
                # least-predicted-wait on a fleet: the assignment recurrence
                # (argmin over waits, push the winner) is evaluated exactly by
                # a compact scalar walk over the speculated edge rows
                nom, HB = self._lpw_assign(ctx, lo, hi, spec_code)
            else:
                HB = np.empty((r, ctx.n_dev))
                for d, nm in enumerate(ctx.dev_names):
                    h0 = ctx.queues[nm].horizon_ms
                    if spec_code is None:
                        HB[:, d] = h0  # frozen: no pushes assumed
                    else:
                        mask = spec_code == ctx.edge_col
                        if ctx.nom_fixed is not None and ctx.n_dev > 1:
                            mask = mask & (ctx.nom_fixed[lo:hi] == d)
                        rows = np.nonzero(mask)[0]
                        hb, _ = horizon_before(
                            h0, nows[rows], ctx.e_comp[lo:hi][rows, d], rows, r)
                        HB[:, d] = hb
            waits = np.maximum(HB - nows[:, None], 0.0)
            if nom is None:
                if ctx.nom_fixed is not None:
                    nom = ctx.nom_fixed[lo:hi]
                else:  # frozen LPW: first-min argmin == fleet-order ties
                    nom = waits.argmin(axis=1)

        # --- CIL warm/cold flags under the speculated dispatches ------------
        cold_flags = np.empty((r, ctx.n_cloud), dtype=bool)
        events: list[tuple[int, str, float, float]] = []  # (row, name, now, completion)
        for t, nm in enumerate(ctx.cloud_names):
            recs = ctx.cil.containers.get(nm, [])
            busy_l = [c.busy_until for c in recs]
            last_l = [c.last_completion for c in recs]
            ev = (np.nonzero(spec_code == t)[0].tolist()
                  if spec_code is not None else [])
            if not ev:
                cold_flags[:, t] = ~_warm_any(
                    np.asarray(busy_l), np.asarray(last_l), ctx.t_idl, nows)
                continue
            col = np.empty(r, dtype=bool)
            tb = ctx.batch.cloud[nm]
            tgt = ctx.engine.predictor._target(nm)
            t_idl = ctx.t_idl
            prev = 0
            for j in ev:
                if j > prev:
                    col[prev:j] = ~_warm_any(
                        np.asarray(busy_l), np.asarray(last_l), t_idl,
                        nows[prev:j])
                tnow = float(nows[j])
                best = -1
                best_last = -np.inf
                for i2 in range(len(busy_l)):
                    if busy_l[i2] <= tnow <= last_l[i2] + t_idl:
                        if last_l[i2] > best_last:
                            best_last = last_l[i2]
                            best = i2
                is_cold = best < 0
                col[j] = is_cold
                src = tb.cold if is_cold else tb.warm
                comps = {k: float(v[lo + j]) for k, v in src.items()}
                completion = tnow + tgt.occupancy_ms(comps)
                if is_cold:
                    busy_l.append(completion)
                    last_l.append(completion)
                else:
                    busy_l[best] = completion
                    last_l[best] = completion
                events.append((j, nm, tnow, completion))
                prev = j + 1
            if prev < r:
                col[prev:] = ~_warm_any(
                    np.asarray(busy_l), np.asarray(last_l), ctx.t_idl,
                    nows[prev:])
            cold_flags[:, t] = col

        # --- (r, T) latency/cost matrices in the policy-view column order ---
        LAT = np.empty((r, ctx.T))
        COST = np.empty((r, ctx.T))
        COMP = np.empty((r, ctx.T))
        for t in range(ctx.n_cloud):
            cf = cold_flags[:, t]
            LAT[:, t] = np.where(cf, ctx.ccold[t][lo:hi], ctx.cwarm[t][lo:hi])
            COST[:, t] = ctx.ccost[t][lo:hi]
            COMP[:, t] = ctx.ccomp[t][lo:hi]
        if ctx.has_edge:
            rr = np.arange(r)
            ew = waits[rr, nom]
            LAT[:, ctx.edge_col] = ew + ctx.e_lat[lo:hi][rr, nom]
            COST[:, ctx.edge_col] = ctx.e_cost[lo:hi][rr, nom]
            COMP[:, ctx.edge_col] = ctx.e_comp[lo:hi][rr, nom]

        # --- the policy kernel: masked lexicographic argmin -----------------
        policy = self.policy
        if ctx.is_minlat:
            c_max, alpha = policy.c_max, policy.alpha
            if spec_code is None:
                s_traj = np.full(r + 1, policy.surplus)
            else:
                rr0 = np.arange(r)
                s_traj = surplus_trajectory(
                    policy.surplus, c_max, COST[rr0, spec_code])
            allowed = c_max + alpha * s_traj[:-1]
            feas = COST <= allowed[:, None]
            none_f = ~feas.any(axis=1)
            if none_f.any():
                if ctx.has_edge:
                    # fallback set is exactly {nominated edge device}
                    feas[none_f] = False
                    feas[none_f, ctx.edge_col] = True
                else:
                    feas[none_f] = True  # fallback set is all targets
            l1 = np.where(feas, LAT, np.inf)
            lmin = l1.min(axis=1)
            tie = feas & (LAT == lmin[:, None])
            c2 = np.where(tie, COST, np.inf)
            cmin = c2.min(axis=1)
            final = tie & (COST == cmin[:, None])
            code = final.argmax(axis=1).astype(np.int64)
            feas_out = np.ones(r, dtype=bool)
        else:  # MinCostPolicy (always has an edge column — see eligibility)
            deadline = policy.deadline_ms
            feas = LAT <= deadline
            any_f = feas.any(axis=1)
            c1 = np.where(feas, COST, np.inf)
            cmin = c1.min(axis=1)
            tie = feas & (COST == cmin[:, None])
            l2 = np.where(tie, LAT, np.inf)
            lmin = l2.min(axis=1)
            final = tie & (LAT == lmin[:, None])
            code = final.argmax(axis=1).astype(np.int64)
            if ctx.has_edge:
                code[~any_f] = ctx.edge_col
            allowed = np.full(r, np.inf)
            feas_out = any_f
            s_traj = None

        rr = np.arange(r)
        lat_ch = LAT[rr, code]
        cost_ch = COST[rr, code]
        comp_ch = COMP[rr, code]
        if ctx.has_edge:
            is_edge_ch = code == ctx.edge_col
            cold_ch = np.zeros(r, dtype=bool)
            cl = ~is_edge_ch
            cold_ch[cl] = cold_flags[rr[cl], code[cl]]
            wait_ch = np.where(is_edge_ch, ew, 0.0)
        else:
            cold_ch = cold_flags[rr, code]
            wait_ch = np.zeros(r)

        return {
            "code": code, "nom": nom,
            "lat": lat_ch, "cost": cost_ch, "cold": cold_ch, "comp": comp_ch,
            "wait": wait_ch, "allowed": allowed, "feas": feas_out,
            "s_traj": s_traj, "HB": HB, "events": events,
        }

    def _cw_scalar_rows(self, ctx: _ColumnarContext, lo: int, hi: int,
                        out) -> None:
        """Decide rows [lo, hi) one at a time on the columnar arrays.

        Bit-identical to the per-task walk — the same comparisons in the same
        order — but over pre-gathered float lists instead of per-task
        ``Prediction`` dicts, so it is still several times faster. Used when
        a window's choices oscillate too fast for speculation to pay.
        """
        (out_code, out_lat, out_cost, out_cold, out_comp, out_wait,
         out_feas, out_allowed, out_dev) = out
        policy = self.policy
        is_minlat = ctx.is_minlat
        cil = ctx.cil
        t_idl = ctx.t_idl
        nc = ctx.n_cloud
        nd = ctx.n_dev
        has_edge = ctx.has_edge
        edge_col = ctx.edge_col
        nows_l = ctx.nows[lo:hi].tolist()
        cwarm_l = [c[lo:hi].tolist() for c in ctx.cwarm]
        ccold_l = [c[lo:hi].tolist() for c in ctx.ccold]
        ccost_l = [c[lo:hi].tolist() for c in ctx.ccost]
        ccomp_l = [c[lo:hi].tolist() for c in ctx.ccomp]
        if has_edge:
            e_lat_l = [ctx.e_lat[lo:hi, d].tolist() for d in range(nd)]
            e_cost_l = [ctx.e_cost[lo:hi, d].tolist() for d in range(nd)]
            e_comp_l = [ctx.e_comp[lo:hi, d].tolist() for d in range(nd)]
            queues = [ctx.queues[nm] for nm in ctx.dev_names]
        nom_fixed = ctx.nom_fixed
        targets = [self.predictor._target(nm) for nm in ctx.cloud_names]
        tbs = [ctx.batch.cloud[nm] for nm in ctx.cloud_names]

        for i in range(hi - lo):
            now = nows_l[i]
            g = lo + i
            # balancer nomination + nominated-device wait
            if has_edge:
                if nom_fixed is not None:
                    d_nom = int(nom_fixed[g])
                    wait = queues[d_nom].horizon_ms - now
                    if wait < 0.0:
                        wait = 0.0
                else:
                    d_nom = 0
                    wait = queues[0].horizon_ms - now
                    if wait < 0.0:
                        wait = 0.0
                    for d in range(1, nd):
                        w = queues[d].horizon_ms - now
                        if w < 0.0:
                            w = 0.0
                        if w < wait:
                            wait = w
                            d_nom = d
                edge_lat = wait + e_lat_l[d_nom][i]
                edge_cost = e_cost_l[d_nom][i]
            # per-column (lat, cost) with induced CIL warm/cold
            lats = [0.0] * ctx.T
            costs = [0.0] * ctx.T
            colds = [False] * ctx.T
            for t in range(nc):
                warm = False
                for c in cil.containers.get(ctx.cloud_names[t], ()):
                    if c.busy_until <= now <= c.last_completion + t_idl:
                        warm = True
                        break
                colds[t] = not warm
                lats[t] = ccold_l[t][i] if not warm else cwarm_l[t][i]
                costs[t] = ccost_l[t][i]
            if has_edge:
                lats[edge_col] = edge_lat
                costs[edge_col] = edge_cost
            # the policy's lexicographic min, first-wins (dict order == columns)
            if is_minlat:
                allowed = policy.c_max + policy.alpha * policy.surplus
                best = -1
                for t in range(ctx.T):
                    if costs[t] <= allowed and (
                            best < 0 or lats[t] < lats[best]
                            or (lats[t] == lats[best] and costs[t] < costs[best])):
                        best = t
                if best < 0:
                    best = edge_col if has_edge else min(
                        range(ctx.T), key=lambda t: (lats[t], costs[t]))
                feasible = True
            else:
                allowed = float("inf")
                deadline = policy.deadline_ms
                best = -1
                for t in range(ctx.T):
                    if lats[t] <= deadline and (
                            best < 0 or costs[t] < costs[best]
                            or (costs[t] == costs[best] and lats[t] < lats[best])):
                        best = t
                feasible = best >= 0
                if not feasible:
                    best = edge_col  # min-cost always has an edge column
            # outputs + state effects
            out_lat[g] = lats[best]
            out_cost[g] = costs[best]
            out_allowed[g] = allowed
            out_feas[g] = feasible
            if is_minlat:
                policy.surplus += policy.c_max - costs[best]
            if has_edge and best == edge_col:
                out_code[g] = nc + d_nom
                out_cold[g] = False
                out_comp[g] = e_comp_l[d_nom][i]
                out_wait[g] = wait
                q = queues[d_nom]
                h = q.horizon_ms
                q.horizon_ms = (h if h > now else now) + e_comp_l[d_nom][i]
            else:
                out_code[g] = best
                out_cold[g] = colds[best]
                out_comp[g] = ccomp_l[best][i]
                out_wait[g] = 0.0
                tb = tbs[best]
                src = tb.cold if colds[best] else tb.warm
                comps = {k: float(v[g]) for k, v in src.items()}
                cil.record_dispatch(ctx.cloud_names[best], now,
                                    now + targets[best].occupancy_ms(comps))
            if has_edge:
                out_dev[g] = d_nom

    def _lpw_assign(self, ctx: _ColumnarContext, lo: int, hi: int,
                    spec_code: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Exact least-predicted-wait assignment under the speculated
        edge/cloud pattern: per row, argmin over per-device waits (ties break
        by fleet order, like ``LeastPredictedWaitBalancer.pick``), pushing the
        winner's horizon when the row is speculated onto the edge.

        A compact scalar walk over plain float lists — the recurrence's
        winner feeds back into the next row's argmin, so there is no segment
        form; the per-row work is a handful of float ops over ``n_dev``
        devices, orders of magnitude cheaper than the per-task predict walk.
        Returns ``(nominations, horizons_before)``.
        """
        r = hi - lo
        nd = ctx.n_dev
        nows_l = ctx.nows[lo:hi].tolist()
        spec_l = spec_code.tolist()
        edge_col = ctx.edge_col
        h = [ctx.queues[nm].horizon_ms for nm in ctx.dev_names]
        comp_cols = [ctx.e_comp[lo:hi, d].tolist() for d in range(nd)]
        hb_cols = [[0.0] * r for _ in range(nd)]
        nom_l = [0] * r
        for i in range(r):
            now = nows_l[i]
            best = 0
            bw = h[0] - now
            if bw < 0.0:
                bw = 0.0
            hb_cols[0][i] = h[0]
            for d in range(1, nd):
                hv = h[d]
                hb_cols[d][i] = hv
                w = hv - now
                if w < 0.0:
                    w = 0.0
                if w < bw:
                    bw = w
                    best = d
            nom_l[i] = best
            if spec_l[i] == edge_col:
                hv = h[best]
                h[best] = (hv if hv > now else now) + comp_cols[best][i]
        return np.array(nom_l, dtype=np.int64), np.array(hb_cols).T

    def _cw_accept(self, ctx: _ColumnarContext, res: dict, lo: int, a: int,
                   out) -> None:
        """Commit ``a`` verified rows starting at absolute row ``lo``.

        Rows ``[0, a-1)`` of the pass matched their speculation, so every
        induced trajectory through them is the true execution; row ``a-1``
        carries the *recomputed* (exact) decision, whose state effects are
        applied explicitly here — the repair step of speculate-and-repair.
        """
        (out_code, out_lat, out_cost, out_cold, out_comp, out_wait,
         out_feas, out_allowed, out_dev) = out
        code = res["code"]
        sl = slice(lo, lo + a)
        out_lat[sl] = res["lat"][:a]
        out_cost[sl] = res["cost"][:a]
        out_cold[sl] = res["cold"][:a]
        out_comp[sl] = res["comp"][:a]
        out_wait[sl] = res["wait"][:a]
        out_feas[sl] = res["feas"][:a]
        out_allowed[sl] = res["allowed"][:a]
        acc_code = code[:a]
        if ctx.has_edge:
            nom = res["nom"]
            out_dev[sl] = nom[:a]
            # map policy-view codes to the global table: edge → n_cloud + dev
            gc = acc_code.copy()
            em = gc == ctx.edge_col
            gc[em] = ctx.n_cloud + nom[:a][em]
            out_code[sl] = gc
        else:
            out_code[sl] = acc_code

        k = a - 1  # the repaired (or final) row — exact decision, fresh effects
        # surplus bank
        policy = self.policy
        if ctx.is_minlat:
            s_traj = res["s_traj"]
            policy.surplus = float(s_traj[k] + (policy.c_max - res["cost"][k]))
        # edge horizons: the speculated trajectory is exact through row k-1
        # (all matched), so commit the horizon *before* row k and then apply
        # row k's push with its corrected choice — never the speculated one.
        if ctx.has_edge:
            HB = res["HB"]
            for d, nm in enumerate(ctx.dev_names):
                ctx.queues[nm].horizon_ms = float(HB[k, d])
            if code[k] == ctx.edge_col:
                d = int(res["nom"][k])
                q = ctx.queues[ctx.dev_names[d]]
                q.horizon_ms = max(float(HB[k, d]), float(ctx.nows[lo + k])) \
                    + float(ctx.e_comp[lo + k, d])
        # CIL: replay speculated dispatches at rows < k, then row k's own
        for row, nm, tnow, completion in sorted(res["events"]):
            if row < k:
                ctx.cil.record_dispatch(nm, tnow, completion)
        if (not ctx.has_edge) or code[k] != ctx.edge_col:
            t = int(code[k])
            nm = ctx.cloud_names[t]
            tb = ctx.batch.cloud[nm]
            src = tb.cold if res["cold"][k] else tb.warm
            comps = {kk: float(v[lo + k]) for kk, v in src.items()}
            tnow = float(ctx.nows[lo + k])
            completion = tnow + ctx.engine.predictor._target(nm).occupancy_ms(comps)
            ctx.cil.record_dispatch(nm, tnow, completion)

    # ------------------------------------------------------------------
    def _decide(self, task, now: float, preds: dict[str, Prediction],
                waits: Mapping[str, float] | None = None) -> PlacementDecision:
        names = self.edge_names
        if len(names) > 1:
            edge_choice = self.balancer.pick(names, waits or {}, preds)
            # the policy is defined against ONE λ_edge: it sees the cloud
            # configs plus the balancer's nominated device only
            policy_view = {n: p for n, p in preds.items()
                           if n == edge_choice or n not in names}
        else:
            edge_choice = names[0] if names else self.edge_name
            policy_view = preds
        name, feasible, allowed = self.policy.choose(policy_view, edge_choice)
        chosen = preds[name]
        hedge = self.policy.hedge(policy_view, name, allowed, edge_choice)
        if hedge is not None and hedge[0] == name:
            hedge = None  # a duplicate of the primary is not a hedge
        self.policy.observe(chosen)
        self.predictor.update_cil(name, now, chosen)
        if hedge is not None:
            # the duplicate dispatch occupies a container too
            self.predictor.update_cil(hedge[0], now, hedge[1])
        d = PlacementDecision(
            task_idx=getattr(task, "idx", -1),
            target=name,
            prediction=chosen,
            feasible=feasible,
            allowed_cost=allowed,
            hedge_target=hedge[0] if hedge is not None else None,
            hedge_prediction=hedge[1] if hedge is not None else None,
            edge_device=edge_choice if names else None,
        )
        if self.record_decisions:
            self.decisions.append(d)
        return d
