"""The unified placement runtime: one serve loop, pluggable execution backends.

The paper's framework is a single Decision Engine driving many execution
substrates (Greengrass edge devices, Lambda configurations). This module makes
that architecture literal:

- ``ExecutionBackend`` is the substrate contract — ``execute(task, target,
  now) -> ExecutionOutcome`` plus a non-mutating ``probe_cold`` — implemented
  by ``TwinBackend`` (the AWS digital twin: event-driven simulation, paper
  Sec. VI-A) here and by ``repro_torch.serving.placement.LiveBackend`` (the real
  executor pool, Sec. VI-B) on the serving side;
- ``PlacementRuntime`` is the ONE serve loop shared by simulation and the live
  prototype. It owns the *predicted* edge-queue horizons — one
  ``PredictedEdgeQueue`` per fleet device — asks the Decision Engine for
  placements (batched ``place_many`` by default, per-task ``step`` otherwise),
  executes them through the backend, and merges hedged duplicates
  (first-completion-wins, both billed);
- policies are consumed only through the formal ``Policy`` protocol —
  constraints for result reporting come from ``policy.constraints()``, hedges
  from the ``hedge`` hook carried on the ``PlacementDecision``.

Placement is non-blocking (paper Sec. III-A): decisions happen at ingestion
time from *predicted* state only, so the decision loop factors cleanly out of
execution — which is what lets ``serve`` run the vectorized batched path
without changing any observable behavior.

``TwinBackend`` additionally implements ``execute_many``: the whole ground
truth is sampled in batched numpy (upload / start / compute / store legs as
one ``standard_normal`` block per substrate stream) instead of per-task scalar
draws, BIT-IDENTICAL to the sequential ``execute`` loop — numpy Generators
produce the same stream whether normals are drawn one at a time or in a block,
and every leg is an affine/exp transform of a standard normal. Only the
container-pool and per-device FIFO recurrences stay sequential (cheap Python,
no model math). This is what makes 100k-task fleet workloads fast — see
``benchmarks/bench_runtime.py``.

The STREAMING serve path (``PlacementRuntime.serve_stream``) runs the same
columnar pipeline over arrival chunks: every sequential state carrier — the
CIL, the Alg. 1 surplus bank, the predicted edge-queue horizons, the
per-(substrate, leg) RNG streams, and the twin's ground-truth container pool —
lives OUTSIDE the chunk, so the concatenated result is bit-identical to the
one-shot serve for every chunk size while the working set stays
O(chunk × targets). Outcome columns accumulate in a ``RecordArena``
(geometric doubling, in-place merge); ``repro_torch.core.multiapp`` fans N
independent application streams out over this path in parallel shards.

The EVENT-DRIVEN serve path (``PlacementRuntime.serve_async``) reuses the same
non-blocking placement pass and fans execution out to per-target workers — one
per edge device, one per cloud config — that pull rows from the columnar
``DecisionBatch`` by ``target_codes``. On the twin the workers interleave on
the virtual-clock event heap (``repro_torch.core.events``; ``execute_async``,
bit-identical to ``execute_many``); live backends run them as real threads
(``repro_torch.serving.executors.ExecutorPool.serve_concurrent``) so fleet
executions genuinely overlap. Hedge duplicates become race events: first
completion wins, the loser is drained (twin) or cancelled when it never
started (live).
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.events import (
    ARRIVAL,
    COMPLETION,
    DISPATCH,
    PREEMPT,
    EventHeap,
    SingleSlotWorker,
)

from repro_torch.core.apps import (
    AWSTwin,
    FULL_VCPU_MB,
    T_IDL_ACTUAL_MEAN_MS,
    T_IDL_ACTUAL_STD_MS,
)
from repro_torch import resolve_device, spans
from repro_torch.core.decision import (
    ARRAY_BACKENDS,
    DecisionBatch,
    DecisionEngine,
    PlacementDecision,
    PredictedEdgeQueue,
    failover_choice,
)
from repro_torch.core.faults import (
    BLACKOUT,
    OUTAGE,
    TRANSIENT,
    AdmissionPolicy,
    CircuitBreaker,
    FaultSpec,
    RetryPolicy,
    TargetHealth,
)
from repro_torch.core.overload import (
    OverloadManager,
    PrewarmPolicy,
    ReclamationPolicy,
    select_victims,
)
from repro_torch.core.predictor import Prediction
from repro_torch.core.pricing import LambdaPricing
from repro_torch.core.records import RecordArena, RecordBatch, SimulationResult, TaskRecord
from repro_torch.core.recurrence import fifo_starts
from repro_torch.core.workload import TaskChunk, TaskInput, task_arrays, task_tiers


@dataclass(frozen=True)
class ExecutionOutcome:
    """What actually happened when a backend ran one task on one target."""

    latency_ms: float    # end-to-end, including any actual queueing
    cost: float          # billed $ for this execution
    cold: bool           # did the substrate actually cold-start?
    completion_ms: float  # absolute completion time on the arrival clock
    queue_wait_ms: float = 0.0  # actual FIFO wait (edge executors)
    exec_ms: float = 0.0        # executor busy occupancy (utilization metric)
    # fault injection (see ``repro_torch.core.faults``): a failed dispatch bills
    # every leg that actually ran (``cost``/``exec_ms`` reflect them) but
    # produced no result; ``completion_ms`` is when the failure was detected
    failed: bool = False
    fail_kind: int = 0   # faults.OK / TRANSIENT / OUTAGE / BLACKOUT / BREAKER


@dataclass
class ExecutionBatch:
    """Struct-of-arrays form of N ``ExecutionOutcome``s — what a vectorized
    backend naturally produces (``TwinBackend.execute_many``). ``outcomes()``
    or indexing recovers the per-dispatch view."""

    latency_ms: np.ndarray
    cost: np.ndarray
    cold: np.ndarray          # bool
    completion_ms: np.ndarray
    queue_wait_ms: np.ndarray
    exec_ms: np.ndarray
    # set by concurrent runners only: a hedge race leg that was cancelled
    # before it started (it ran nowhere, bills nothing). None = no races.
    cancelled: np.ndarray | None = None
    # set by fault-injecting backends only (None = nothing failed): which
    # dispatches failed and how (``repro_torch.core.faults`` kind codes)
    failed: np.ndarray | None = None
    fail_kind: np.ndarray | None = None

    def __len__(self) -> int:
        return self.latency_ms.shape[0]

    def __getitem__(self, i: int) -> ExecutionOutcome:
        return ExecutionOutcome(
            latency_ms=float(self.latency_ms[i]), cost=float(self.cost[i]),
            cold=bool(self.cold[i]), completion_ms=float(self.completion_ms[i]),
            queue_wait_ms=float(self.queue_wait_ms[i]),
            exec_ms=float(self.exec_ms[i]),
            failed=bool(self.failed[i]) if self.failed is not None else False,
            fail_kind=int(self.fail_kind[i]) if self.fail_kind is not None else 0)

    def outcomes(self) -> list[ExecutionOutcome]:
        return [ExecutionOutcome(lat, c, k, m, q, e)
                for lat, c, k, m, q, e in zip(
                    self.latency_ms.tolist(), self.cost.tolist(),
                    self.cold.tolist(), self.completion_ms.tolist(),
                    self.queue_wait_ms.tolist(), self.exec_ms.tolist())]


@runtime_checkable
class ExecutionBackend(Protocol):
    """An execution substrate: the AWS twin, a live executor pool, ..."""

    def probe_cold(self, target: str, now: float) -> bool:
        """Would a function *triggered* at ``now`` cold-start? (No mutation.)

        ``now`` is the trigger time, not the task arrival time: on the twin,
        the actual cold/warm outcome of a dispatch is judged after the upload
        leg (``arrival + upld``), so pass that time to anticipate it. Not
        consumed by the serve loop itself — exposed for external warm-state
        introspection (dashboards, calibration probes).
        """
        ...

    def execute(self, task: TaskInput, target: str, now: float) -> ExecutionOutcome:
        """Run ``task`` on ``target``, mutating substrate state (queues, pools)."""
        ...


def edge_stream_key(name: str) -> int:
    """Stable per-device RNG stream offset: adding or removing a device can
    never perturb another device's draws (crc32 is process-independent)."""
    return zlib.crc32(name.encode("utf-8"))


CLOUD_LEGS = ("upld", "start", "comp", "store")
EDGE_LEGS = ("comp", "iot", "store")


# The FIFO-start recurrence moved to ``repro_torch.core.recurrence`` so the columnar
# decision core can share it; the old private name stays importable.
_fifo_starts = fifo_starts


# ----------------------------------------------------------------- twin side
@dataclass(slots=True)
class GTContainer:
    busy_until: float
    last_completion: float
    expires_at: float  # actual reclamation time, sampled per idle period


class GroundTruthCloud:
    """The provider's actual container state (what AWS really does)."""

    def __init__(self, twin: AWSTwin, seed: int = 0):
        self.twin = twin
        self.rng = np.random.default_rng(seed)
        self.pools: dict[str, list[GTContainer]] = {}

    def probe(self, config: str, trigger_time: float) -> bool:
        """Would a function triggered now cold-start? (No mutation.)"""
        pool = self.pools.get(config, [])
        idle = [c for c in pool if c.busy_until <= trigger_time and trigger_time <= c.expires_at]
        return len(idle) == 0

    def commit(self, config: str, trigger_time: float, busy_ms: float) -> bool:
        """Trigger a function occupying a container for ``busy_ms``.
        Returns True if this was an actual cold start.

        NOTE: ``TwinBackend.execute_many`` runs this reap / MRU-idle-select /
        occupy-or-append walk inline over parallel float lists (with the
        lifetime draws pre-batched from this object's ``rng``) — any change
        to the pool semantics here must be mirrored there; the bit-parity
        tests in ``tests/test_fleet.py`` catch divergence.
        """
        cold, _ = self.commit_drawn(config, trigger_time, busy_ms, busy_ms,
                                    self.twin.t_idl_ms(self.rng))
        return cold

    def commit_drawn(self, config: str, trigger_time: float, warm_busy_ms: float,
                     cold_busy_ms: float, t_idl_ms: float) -> tuple[bool, float]:
        """``commit`` with pre-drawn randomness: the idle lifetime comes in as
        ``t_idl_ms`` (the batched samplers draw lifetimes as one block, so RNG
        stream order is the caller's job) and the busy occupancy is chosen
        warm/cold by the probe itself. Returns ``(cold, completion_ms)`` —
        what the event-driven runner needs to schedule the completion event.
        """
        pool = self.pools.setdefault(config, [])
        # reap actually-expired idle containers
        pool[:] = [c for c in pool if c.busy_until > trigger_time or trigger_time <= c.expires_at]
        idle = [c for c in pool if c.busy_until <= trigger_time and trigger_time <= c.expires_at]
        cold = not idle
        completion = trigger_time + (cold_busy_ms if cold else warm_busy_ms)
        expiry = completion + t_idl_ms
        if idle:
            c = max(idle, key=lambda c: c.last_completion)
            c.busy_until = completion
            c.last_completion = completion
            c.expires_at = expiry
        else:
            pool.append(GTContainer(busy_until=completion,
                                    last_completion=completion,
                                    expires_at=expiry))
        return cold, completion

    def spinup(self, config: str, ready_ms: float, expires_ms: float) -> None:
        """Speculatively spawn a container (predictive pre-warming): spinning
        up until ``ready_ms``, then idle-warm until its DETERMINISTIC
        keep-alive expiry ``expires_ms``. Never draws from ``self.rng`` — the
        container-lifetime draw block in the batched samplers must see the
        exact same stream with or without pre-warming (bit-parity). A reuse
        converts the container to the normal sampled-lifetime lifecycle."""
        self.pools.setdefault(config, []).append(GTContainer(
            busy_until=float(ready_ms), last_completion=float(ready_ms),
            expires_at=float(expires_ms)))

    def extend_keepalive(self, config: str, ready_ms: float,
                         old_expires_ms: float, new_expires_ms: float) -> bool:
        """Push out the keep-alive expiry of a STILL-UNUSED prewarmed
        container, matched by value — ``execute_many`` rebuilds its pool
        lists as fresh ``GTContainer`` objects, so object identity does not
        survive a dispatch round. A container that was reused no longer
        matches (its ``busy_until`` moved), which is exactly the
        "only extend idle retainers" rule. Returns True when extended."""
        for c in self.pools.get(config, []):
            if c.busy_until == ready_ms and c.expires_at == old_expires_ms:
                c.expires_at = float(new_expires_ms)
                return True
        return False


class TwinBackend:
    """ExecutionBackend over the AWS digital twin (paper Sec. VI-A).

    Actual latencies, billed costs, and warm/cold outcomes come from the
    twin's generative ground truth: a stochastic-lifetime container pool per
    configuration and N single-slot FIFO edge executors (one per fleet
    device) whose *actual* queueing emerges from actual compute times.

    One RNG stream per (substrate, latency leg): the cloud pipeline draws
    upld/start/comp/store each from its own stream, and each edge device
    draws comp/iot/store from streams seeded ``(seed, edge_stream_key(name),
    leg)`` — deterministic and independent of fleet composition, so adding a
    device never perturbs another device's ground truth, and the batched
    sampler can draw each leg as one contiguous block that is bit-identical
    to the per-task scalar draws. ``edge_speed`` maps device → relative
    compute speed (heterogeneous fleets; actual compute is divided by it).
    """

    # the vectorized runners consume DecisionBatch targets without a name list
    accepts_decision_batch = True

    def __init__(self, twin: AWSTwin, seed: int = 0,
                 pricing: LambdaPricing | None = None, edge_name: str = "edge",
                 edge_names: Sequence[str] | None = None,
                 edge_speed: dict[str, float] | None = None,
                 faults: FaultSpec | None = None):
        self.twin = twin
        self.pricing = pricing or LambdaPricing()
        # an empty spec is indistinguishable from no spec: both take exactly
        # the pre-fault code path (zero extra draws, bit-identical output)
        self.faults = faults if faults else None
        self.gt_cloud = GroundTruthCloud(twin, seed=seed)
        self.cloud_rngs = {leg: np.random.default_rng([seed, 7, i])
                           for i, leg in enumerate(CLOUD_LEGS)}
        names = tuple(edge_names) if edge_names is not None else (edge_name,)
        self.edge_names = names
        self.edge_name = names[0] if names else edge_name
        self.edge_speed = {n: float((edge_speed or {}).get(n, 1.0)) for n in names}
        self.edge_rngs = {
            n: {leg: np.random.default_rng([seed, edge_stream_key(n), i])
                for i, leg in enumerate(EDGE_LEGS)}
            for n in names}
        # per-device edge executor state (single-slot FIFO)
        self.edge_free_at = {n: 0.0 for n in names}

    @property
    def edge_free_at_actual(self) -> float:
        """Deprecated single-edge alias for ``edge_free_at[edge_name]``."""
        return self.edge_free_at[self.edge_name]

    @edge_free_at_actual.setter
    def edge_free_at_actual(self, value: float) -> None:
        self.edge_free_at[self.edge_name] = value

    def probe_cold(self, target: str, now: float) -> bool:
        return self.gt_cloud.probe(target, now)

    def execute(self, task: TaskInput, target: str, now: float) -> ExecutionOutcome:
        if target in self.edge_free_at:
            return self._execute_edge(task, now, target)
        return self._execute_cloud(task, target, now)

    def _fault_fast(self, now: float, kind: int) -> ExecutionOutcome:
        """Fail-fast outcome: nothing ran, no draws consumed, no occupancy —
        only the spec's failure-detection latency elapses."""
        d = self.faults.detect_ms
        return ExecutionOutcome(
            latency_ms=d, cost=0.0, cold=False, completion_ms=now + d,
            failed=True, fail_kind=kind)

    def _execute_cloud(self, task: TaskInput, config: str, now: float) -> ExecutionOutcome:
        f = self.faults
        if f is not None:
            # fail-fast faults consume NO draws — mirrored by execute_many
            if bool(f.outage_mask(config, now)):
                return self._fault_fast(now, OUTAGE)
            if bool(f.blackout_mask("upld", config, now)):
                return self._fault_fast(now, BLACKOUT)
        twin, rngs = self.twin, self.cloud_rngs
        upld = twin.upld_ms(task.bytes, rngs["upld"])
        trigger = now + upld
        cold = self.gt_cloud.probe(config, trigger)
        start = twin.start_ms(cold, rngs["start"])
        if f is not None and cold:
            start *= float(f.cold_factor(config, trigger))
        comp = twin.comp_cloud_ms(task.size, float(config), rngs["comp"])
        self.gt_cloud.commit(config, trigger, start + comp)
        store = twin.store_cloud_ms(rngs["store"])
        if f is not None and bool(
                f.transient_mask(config, getattr(task, "idx", -1), now)):
            # the attempt ran its upload/start/compute legs (and bills them);
            # the result was lost — no store leg, failure detected at crash
            latency = upld + start + comp
            return ExecutionOutcome(
                latency_ms=latency, cost=self.pricing.cost(comp, float(config)),
                cold=cold, completion_ms=now + latency, exec_ms=start + comp,
                failed=True, fail_kind=TRANSIENT)
        latency = upld + start + comp + store
        return ExecutionOutcome(
            latency_ms=latency,
            cost=self.pricing.cost(comp, float(config)),
            cold=cold,
            completion_ms=now + latency,
            exec_ms=start + comp,
        )

    def _execute_edge(self, task: TaskInput, now: float,
                      device: str | None = None) -> ExecutionOutcome:
        device = device if device is not None else self.edge_name
        f = self.faults
        if f is not None and bool(f.outage_mask(device, now)):
            return self._fault_fast(now, OUTAGE)  # device down: nothing ran
        twin, rngs = self.twin, self.edge_rngs[device]
        comp = twin.comp_edge_ms(task.size, rngs["comp"]) / self.edge_speed[device]
        if f is not None:
            comp *= float(f.straggler_factor(device, now))
        start_exec = max(self.edge_free_at[device], now)
        self.edge_free_at[device] = start_exec + comp
        iot = twin.iotup_ms(rngs["iot"])
        store = twin.store_edge_ms(rngs["store"])
        wait = start_exec - now
        if f is not None:
            # the compute ran (the executor WAS occupied, draws consumed) but
            # the result never made it back: iot-leg blackout or a transient
            # crash — failure detected ``detect_ms`` after compute finished
            if bool(f.blackout_mask("iot", device, now)):
                kind = BLACKOUT
            elif bool(f.transient_mask(device, getattr(task, "idx", -1), now)):
                kind = TRANSIENT
            else:
                kind = 0
            if kind:
                latency = wait + comp + f.detect_ms
                return ExecutionOutcome(
                    latency_ms=latency, cost=0.0, cold=False,
                    completion_ms=now + latency, queue_wait_ms=wait,
                    exec_ms=comp, failed=True, fail_kind=kind)
        latency = wait + comp + iot + store
        return ExecutionOutcome(
            latency_ms=latency, cost=0.0, cold=False, completion_ms=now + latency,
            queue_wait_ms=wait, exec_ms=comp,
        )

    # --------------------------------------------------- batched leg sampling
    def _scaled_sizes(self, sizes: np.ndarray) -> np.ndarray:
        if self.twin.spec.size_kind == "pixels":
            return sizes / 1e6
        return sizes / 32.0 / 1000.0

    def _cloud_leg_draws(self, cfgs: list[str], scaled: np.ndarray,
                         nbytes: np.ndarray) -> dict[str, np.ndarray]:
        """One block draw per cloud (substrate, leg) stream for ``len(cfgs)``
        dispatches in dispatch order — bit-identical to the per-task scalar
        draws (numpy Generators produce the same stream either way). Also
        draws the container-lifetime block from the ground-truth RNG and
        prices the compute (no randomness), so every number that does NOT
        depend on pool/queue state comes from here; only warm/cold selection
        and FIFO waits are left to the caller's state walk.
        """
        spec = self.twin.spec
        rngs = self.cloud_rngs
        nc = len(cfgs)
        uniq = {c: float(c) for c in set(cfgs)}
        mem = np.array([uniq[c] for c in cfgs])
        share = np.minimum(mem, FULL_VCPU_MB) / FULL_VCPU_MB  # cpu_share, vectorized
        upld = (spec.upld_base_ms + nbytes * spec.upld_ms_per_byte) \
            * rngs["upld"].lognormal(0.0, spec.upld_sigma, nc)
        zs = rngs["start"].standard_normal(nc)  # scaled per warm/cold below
        warm_start = np.maximum(spec.warm_mean + spec.warm_std * zs, 1.0)
        cold_start = np.maximum(spec.cold_mean + spec.cold_std * zs, 1.0)
        comp = (spec.c0_ms + spec.c1_ms * scaled) / share \
            * rngs["comp"].lognormal(0.0, spec.comp_sigma, nc)
        store = np.maximum(
            rngs["store"].normal(spec.store_cloud_mean, spec.store_cloud_std, nc), 1.0)
        zl = self.gt_cloud.rng.standard_normal(nc)
        t_idl = np.maximum(T_IDL_ACTUAL_MEAN_MS + T_IDL_ACTUAL_STD_MS * zl,
                           5 * 60e3)
        cost = np.empty(nc)
        for cfg, fmem in uniq.items():
            m = mem == fmem
            cost[m] = self.pricing.cost_batch(comp[m], fmem)
        return {"upld": upld, "warm_start": warm_start, "cold_start": cold_start,
                "comp": comp, "store": store, "t_idl": t_idl, "cost": cost}

    def _edge_leg_draws(self, dev: str, scaled: np.ndarray) -> dict[str, np.ndarray]:
        """One block draw per leg stream of edge device ``dev`` for its
        dispatches in dispatch order (see ``_cloud_leg_draws``)."""
        spec = self.twin.spec
        rngs = self.edge_rngs[dev]
        nd = scaled.shape[0]
        comp = (spec.e0_ms + spec.e1_ms * scaled) \
            * rngs["comp"].lognormal(0.0, spec.edge_sigma, nd) \
            / self.edge_speed[dev]
        if spec.iotup_mean > 0:  # matches iotup_ms: no draw when unmodeled
            iot = np.maximum(
                rngs["iot"].normal(spec.iotup_mean, spec.iotup_std, nd), 0.0)
        else:
            iot = np.zeros(nd)
        store = np.maximum(
            rngs["store"].normal(spec.store_edge_mean, spec.store_edge_std, nd), 1.0)
        return {"comp": comp, "iot": iot, "store": store}

    def _encode_targets(self, targets) -> tuple[np.ndarray, Sequence[str]]:
        """Integer-encode dispatch targets (device i → i, cloud → -1) and
        return ``(codes, name_of)`` where ``name_of(i)`` is dispatch ``i``'s
        target name. A columnar ``DecisionBatch`` translates through one tiny
        per-table lookup — no per-dispatch Python at all — which is what
        keeps the streaming serve's execution stage GIL-light; a plain name
        sequence takes the per-dispatch encode it always did.
        """
        devmap = {dev: i for i, dev in enumerate(self.edge_names)}
        if isinstance(targets, DecisionBatch):
            trans = np.array([devmap.get(nm, -1) for nm in targets.names],
                             dtype=np.int64)
            table = targets.names
            tcodes = targets.target_codes
            return trans[tcodes], (lambda i: table[tcodes[i]])
        codes = np.array([devmap.get(tg, -1) for tg in targets],
                         dtype=np.int64)
        return codes, (lambda i: targets[i])

    # ------------------------------------------------- vectorized ground truth
    def execute_many(self, tasks: Sequence[TaskInput],
                     targets: "Sequence[str] | DecisionBatch") -> ExecutionBatch:
        """Run one dispatch per (task, target) pair, sampling all ground-truth
        randomness in batched numpy; returns the struct-of-arrays view.

        Bit-identical to calling ``execute`` once per pair in order: every
        latency leg has its own RNG stream, and numpy Generators produce the
        same values whether ``normal``/``lognormal`` are drawn one at a time
        or as one ``size=n`` block; the arithmetic around each draw keeps the
        scalar path's operation order. Only the container pool and the
        per-device FIFO recurrences run sequentially — pure bookkeeping, no
        model math. ``targets`` may be the columnar ``DecisionBatch`` itself
        (the runtime's batched path passes it straight through — no
        per-dispatch name list is ever materialized).
        """
        n = len(tasks)
        _, nows, sizes, nbytes_all = task_arrays(tasks, "as")
        scaled = self._scaled_sizes(sizes)

        codes, name_of = self._encode_targets(targets)
        devmap = {dev: i for i, dev in enumerate(self.edge_names)}
        edge_masks = {dev: codes == i for dev, i in devmap.items()}
        ci = np.nonzero(codes == -1)[0]

        out = ExecutionBatch(
            latency_ms=np.empty(n), cost=np.zeros(n),
            cold=np.zeros(n, dtype=bool), completion_ms=np.empty(n),
            queue_wait_ms=np.zeros(n), exec_ms=np.empty(n))
        placed = 0

        # fault bookkeeping (None = the exact pre-fault path, zero overhead).
        # Faults never touch the leg streams: fail-fast dispatches are carved
        # out BEFORE the block draws (they consume nothing, exactly like the
        # scalar path returning early), and every other fault is a pure
        # function of dispatch time / the dedicated counter-based stream.
        faults = self.faults
        kind_all = np.zeros(n, dtype=np.int8) if faults is not None else None
        idx_all = task_arrays(tasks, "i")[0] if faults is not None else None

        def _rows_of(cfgs_list, cfg):
            return np.array([j for j, c in enumerate(cfgs_list) if c == cfg],
                            dtype=np.int64)

        # ---- cloud: batch the 4 normals per dispatch (upld, start, comp, store)
        nc = ci.shape[0]
        cfgs: list[str] = [name_of(i) for i in ci.tolist()] if nc else []
        if nc and faults is not None:
            cnows = nows[ci]
            skip = np.zeros(nc, dtype=bool)
            for cfg in set(cfgs):
                rows = _rows_of(cfgs, cfg)
                om = faults.outage_mask(cfg, cnows[rows])
                bm = faults.blackout_mask("upld", cfg, cnows[rows]) & ~om
                kind_all[ci[rows[om]]] = OUTAGE
                kind_all[ci[rows[bm]]] = BLACKOUT
                skip[rows] = om | bm
            if skip.any():
                gi = ci[skip]
                dms = faults.detect_ms
                out.latency_ms[gi] = dms
                out.completion_ms[gi] = nows[gi] + dms
                out.exec_ms[gi] = 0.0
                placed += int(np.count_nonzero(skip))
                keep = ~skip
                ci = ci[keep]
                cfgs = [cfgs[j] for j in np.nonzero(keep)[0].tolist()]
                nc = ci.shape[0]
        if nc:
            nbytes = nbytes_all[ci] if nbytes_all is not None \
                else np.array([tasks[i].bytes for i in ci.tolist()])
            draws = self._cloud_leg_draws(cfgs, scaled[ci], nbytes)
            upld, comp, store = draws["upld"], draws["comp"], draws["store"]
            warm_start, cold_start = draws["warm_start"], draws["cold_start"]
            t_idl = draws["t_idl"]
            # sequential container-pool walk (state only; all draws done
            # above). Probe+commit fused into one scan per dispatch — reap,
            # find the most-recently-used idle container, occupy or append —
            # run per config over parallel float lists (pools are independent
            # across configs, so grouping preserves each pool's dispatch
            # order; the lifetime draws stay in global dispatch order).
            trigger = nows[ci] + upld
            if faults is not None and faults.cold_spikes:
                # cold-start storm: spike windows scale the cold candidate
                # (judged at the trigger time, like the warm/cold probe)
                cold_start = cold_start.copy()
                for cfg in set(cfgs):
                    rows = _rows_of(cfgs, cfg)
                    cold_start[rows] *= faults.cold_factor(cfg, trigger[rows])
            trig_l = trigger.tolist()
            comp_l = comp.tolist()
            warm_l = warm_start.tolist()
            cold_l = cold_start.tolist()
            tidl_l = t_idl.tolist()
            start_l = [0.0] * nc
            was_cold = [False] * nc
            pools = self.gt_cloud.pools
            by_cfg: dict[str, list[int]] = {}
            for j, cfg in enumerate(cfgs):
                lst = by_cfg.get(cfg)
                if lst is None:
                    lst = by_cfg[cfg] = []
                lst.append(j)
            for cfg, js in by_cfg.items():
                pool = pools.setdefault(cfg, [])
                busy_l = [c.busy_until for c in pool]
                last_l = [c.last_completion for c in pool]
                exp_l = [c.expires_at for c in pool]
                for j in js:
                    t = trig_l[j]
                    best = -1
                    best_last = -1e308
                    reap = False
                    for i in range(len(busy_l)):
                        if busy_l[i] <= t:
                            if t <= exp_l[i]:
                                li = last_l[i]
                                if li > best_last:
                                    best_last = li
                                    best = i
                            else:
                                reap = True  # expired idle container
                    if reap:  # rare (27-min lifetimes): rebuild only when needed
                        nb: list[float] = []
                        nl: list[float] = []
                        ne: list[float] = []
                        best = -1
                        best_last = -1e308
                        for i in range(len(busy_l)):
                            b, li, e = busy_l[i], last_l[i], exp_l[i]
                            if b > t or t <= e:
                                if b <= t and li > best_last:
                                    best_last = li
                                    best = len(nb)
                                nb.append(b)
                                nl.append(li)
                                ne.append(e)
                        busy_l, last_l, exp_l = nb, nl, ne
                    st = warm_l[j] if best >= 0 else cold_l[j]
                    busy = st + comp_l[j]
                    completion_t = t + busy
                    expiry = completion_t + tidl_l[j]
                    if best >= 0:
                        busy_l[best] = completion_t
                        last_l[best] = completion_t
                        exp_l[best] = expiry
                    else:
                        busy_l.append(completion_t)
                        last_l.append(completion_t)
                        exp_l.append(expiry)
                        was_cold[j] = True
                    start_l[j] = st
                pools[cfg] = [GTContainer(b, li, e)
                              for b, li, e in zip(busy_l, last_l, exp_l)]
            start = np.asarray(start_l)
            latency = upld + start + comp + store
            if faults is not None:
                tmask = np.zeros(nc, dtype=bool)
                cn = nows[ci]
                for cfg in set(cfgs):
                    if faults.transient_p(cfg) <= 0.0:
                        continue
                    rows = _rows_of(cfgs, cfg)
                    tmask[rows] = faults.transient_mask(
                        cfg, idx_all[ci[rows]], cn[rows])
                if tmask.any():
                    # crashed attempts ran upload/start/compute (billed, and
                    # the container WAS occupied) but never stored a result
                    latency = latency - store * tmask
                    kind_all[ci[tmask]] = TRANSIENT
            out.latency_ms[ci] = latency
            out.cost[ci] = draws["cost"]
            out.cold[ci] = was_cold
            out.completion_ms[ci] = nows[ci] + latency
            out.exec_ms[ci] = start + comp
            placed += nc

        # ---- edge: per-device batched draws + exact FIFO recurrence
        for dev in self.edge_names:
            di = np.nonzero(edge_masks[dev])[0]
            nd = di.shape[0]
            if nd == 0:
                continue
            if faults is not None:
                om = faults.outage_mask(dev, nows[di])
                if om.any():
                    # device down: fail fast, no draws, no FIFO occupancy
                    gi = di[om]
                    dms = faults.detect_ms
                    out.latency_ms[gi] = dms
                    out.completion_ms[gi] = nows[gi] + dms
                    out.exec_ms[gi] = 0.0
                    kind_all[gi] = OUTAGE
                    placed += int(np.count_nonzero(om))
                    di = di[~om]
                    nd = di.shape[0]
                    if nd == 0:
                        continue
            edraws = self._edge_leg_draws(dev, scaled[di])
            comp, iot, store = edraws["comp"], edraws["iot"], edraws["store"]
            dev_nows = nows[di]
            if faults is not None:
                comp = comp * faults.straggler_factor(dev, dev_nows)
            start_exec, free = _fifo_starts(self.edge_free_at[dev], dev_nows, comp)
            self.edge_free_at[dev] = free
            wait = start_exec - dev_nows
            latency = wait + comp + iot + store
            if faults is not None:
                bm = faults.blackout_mask("iot", dev, dev_nows)
                tm = faults.transient_mask(dev, idx_all[di], dev_nows) & ~bm
                lost = bm | tm
                if lost.any():
                    # compute ran (FIFO occupied) but the result never made
                    # it back — detected ``detect_ms`` after compute finished
                    latency = np.where(lost, wait + comp + faults.detect_ms,
                                       latency)
                    kind_all[di[bm]] = BLACKOUT
                    kind_all[di[tm]] = TRANSIENT
            out.latency_ms[di] = latency
            out.completion_ms[di] = dev_nows + latency
            out.queue_wait_ms[di] = wait
            out.exec_ms[di] = comp
            placed += nd

        assert placed == n  # every dispatch is either a fleet device or cloud
        if faults is not None:
            out.fail_kind = kind_all
            out.failed = kind_all != 0
        return out

    # --------------------------------------------- event-driven virtual clock
    def execute_async(self, tasks: Sequence[TaskInput],
                      targets: Sequence[str],
                      races: Sequence[tuple[int, int]] | None = None,
                      ) -> ExecutionBatch:
        """The event-driven virtual-clock runner (``serve_async``'s substrate).

        Per-target workers — one ``SingleSlotWorker`` per edge device, one
        dispatcher per cloud config — interleave on one ``EventHeap``:
        arrivals route each dispatch to its worker, dispatch events occupy
        executors, completion events free them and start the next queued task.
        BIT-IDENTICAL to ``execute_many`` (and therefore to the sequential
        ``execute`` loop): every leg draw comes from the same per-(substrate,
        leg) block sampling, cloud container commits apply in dispatch order
        per config (the provider's ingest order — the heap schedules *when*
        work happens, never reorders *whose* state it touches), and the edge
        workers run the exact ``start = max(free, now)`` FIFO recurrence that
        ``fifo_starts`` evaluates as cumsums. The parity is regression-tested.

        ``races`` (hedge duplicate pairs of dispatch indices) is accepted for
        protocol compatibility: on the twin both legs always run to completion
        on the virtual clock ("drained"), and the runtime merges the race by
        earliest completion — identical to the batched hedge merge. Live
        backends may instead cancel a not-yet-started loser.
        """
        del races  # virtual legs are always drained; the runtime merges
        if self.faults is not None:
            # Faults are pure functions of dispatch time and the dedicated
            # counter-based stream, so the event interleaving cannot change
            # them — route through execute_many, which is bit-identical by
            # the same contract that covers unsorted arrivals below. This is
            # what makes the fault schedule provably path-independent.
            return self.execute_many(tasks, targets)
        n = len(tasks)
        out = ExecutionBatch(
            latency_ms=np.empty(n), cost=np.zeros(n),
            cold=np.zeros(n, dtype=bool), completion_ms=np.empty(n),
            queue_wait_ms=np.zeros(n), exec_ms=np.empty(n))
        if n == 0:
            return out
        _, nows, sizes, nbytes_all = task_arrays(tasks, "as")
        if n > 1 and not bool(np.all(np.diff(nows) >= 0.0)):
            # Out-of-order dispatch lists: the heap would replay state in
            # time order while the batched/sequential paths replay dispatch
            # order. execute_many is bit-identical to the execute loop, so
            # falling back preserves the runner's identical-results contract
            # (all shipped workloads emit sorted arrivals; hedge duplicates
            # share their primary's arrival and tie-break by dispatch order).
            return self.execute_many(tasks, targets)
        scaled = self._scaled_sizes(sizes)
        codes, name_of = self._encode_targets(targets)
        devmap = {dev: i for i, dev in enumerate(self.edge_names)}
        ci = np.nonzero(codes == -1)[0]

        # every leg draw up front, one block per stream (== execute_many)
        cloud_slot = {}
        cdraws = None
        cfgs: list[str] = []
        if ci.shape[0]:
            cfgs = [name_of(i) for i in ci.tolist()]
            nbytes = nbytes_all[ci] if nbytes_all is not None \
                else np.array([tasks[i].bytes for i in ci.tolist()])
            cdraws = self._cloud_leg_draws(cfgs, scaled[ci], nbytes)
            cloud_slot = {int(g): j for j, g in enumerate(ci.tolist())}
        edraws: dict[str, dict[str, np.ndarray]] = {}
        edge_slot: dict[int, int] = {}
        for dev in self.edge_names:
            di = np.nonzero(codes == devmap[dev])[0]
            if di.shape[0]:
                edraws[dev] = self._edge_leg_draws(dev, scaled[di])
                edge_slot.update(
                    {int(g): j for j, g in enumerate(di.tolist())})

        workers = {dev: SingleSlotWorker(free_at=self.edge_free_at[dev])
                   for dev in self.edge_names}

        def start_edge(dev: str, start: float, row: int) -> None:
            """Row occupies ``dev``'s slot at ``start``: write its outcome,
            schedule the slot-free completion."""
            j = edge_slot[row]
            d = edraws[dev]
            comp = float(d["comp"][j])
            arrival = float(nows[row])
            wait = start - arrival
            latency = wait + comp + float(d["iot"][j]) + float(d["store"][j])
            out.latency_ms[row] = latency
            out.completion_ms[row] = arrival + latency
            out.queue_wait_ms[row] = wait
            out.exec_ms[row] = comp
            heap.push(start + comp, COMPLETION, (dev, row))

        heap = EventHeap()
        for i in range(n):
            heap.push(float(nows[i]), ARRIVAL, i)
        for ev in heap.drain():
            if ev.kind == ARRIVAL:
                row = ev.payload
                code = int(codes[row])
                if code >= 0:  # edge: enter the device's FIFO
                    dev = self.edge_names[code]
                    started = workers[dev].arrive(ev.time_ms, row)
                    if started is not None:
                        heap.push(started[0], DISPATCH, (dev, row))
                else:  # cloud: containers scale out — commit at ingest
                    j = cloud_slot[row]
                    trigger = ev.time_ms + float(cdraws["upld"][j])
                    warm, cold_s = (float(cdraws["warm_start"][j]),
                                    float(cdraws["cold_start"][j]))
                    comp = float(cdraws["comp"][j])
                    cold, _ = self.gt_cloud.commit_drawn(
                        cfgs[j], trigger, warm + comp, cold_s + comp,
                        float(cdraws["t_idl"][j]))
                    start = cold_s if cold else warm
                    latency = (float(cdraws["upld"][j]) + start + comp
                               + float(cdraws["store"][j]))
                    out.latency_ms[row] = latency
                    out.cost[row] = float(cdraws["cost"][j])
                    out.cold[row] = cold
                    out.completion_ms[row] = ev.time_ms + latency
                    out.exec_ms[row] = start + comp
                    # no COMPLETION event: cloud containers scale out, so a
                    # finishing dispatch frees no worker slot and nothing
                    # downstream consumes the pop. The completion-ordered
                    # view of a run lives in RecordBatch.completion_order().
            elif ev.kind == DISPATCH:
                dev, row = ev.payload
                start_edge(dev, ev.time_ms, row)
            else:  # COMPLETION: the edge slot frees, the next queued task starts
                dev, _row = ev.payload
                nxt = workers[dev].complete(ev.time_ms)
                if nxt is not None:
                    heap.push(nxt[0], DISPATCH, (dev, nxt[1]))
        for dev, w in workers.items():
            self.edge_free_at[dev] = w.free_at
        return out


def _iter_chunks(workload, chunk_size: int):
    """Normalize any workload spelling into an iterator of task chunks.

    Sequences (``list[TaskInput]`` / ``TaskChunk``) are sliced into
    ``chunk_size`` spans; iterators of ``TaskInput`` are buffered into lists
    of ``chunk_size``; iterators of ready chunks (what ``Workload.chunks``
    yields) pass through at their producer's sizing.
    """
    if isinstance(workload, (list, tuple, TaskChunk)):
        for lo in range(0, len(workload), chunk_size):
            yield workload[lo:lo + chunk_size]
        return
    it = iter(workload)
    first = next(it, None)
    if first is None:
        return
    if isinstance(first, TaskInput):
        buf = [first]
        for t in it:
            buf.append(t)
            if len(buf) >= chunk_size:
                yield buf
                buf = []
        if buf:
            yield buf
        return
    yield first
    yield from it


def _engine_core(eng):
    """The engine's cached torch placement core, or None (never builds one)."""
    hit = eng.__dict__.get("_torch_core_cache")
    return hit[1] if hit is not None else None


def _prefetched_chunks(it, eng, counters: dict):
    """Double-buffered chunk staging for a torch-backed ``serve_stream``.

    A single transfer thread pulls chunk k+1 from the workload iterator AND
    stages its padded task columns on the device (``torch_core.stage_chunk``:
    pinned host buffers copied on a side CUDA stream, with an event that
    ``place_chunk`` waits on) while the consumer places chunk k —
    overlapping workload generation and the host-to-device copy with
    device compute. The staged bundle is handed to ``place_chunk`` through
    ``eng._torch_staged`` (set here on the CONSUMER thread at yield time, so
    the dict is never raced) and validated by chunk identity; a chunk that
    ends up on a fallback path leaves its bundle to be discarded. A staging
    failure raises out of the stream.
    """
    from concurrent.futures import ThreadPoolExecutor

    def pull():
        chunk = next(it, None)
        if chunk is None:
            return None
        staged = None
        if len(chunk):
            core = _engine_core(eng)  # appears once the first chunk placed
            if core is not None:
                staged = core.stage_chunk(chunk)
        return chunk, staged

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(pull)
        while True:
            item = fut.result()
            if item is None:
                return
            fut = ex.submit(pull)
            chunk, staged = item
            if staged is not None:
                eng.__dict__["_torch_staged"] = (chunk, staged)
                counters["prefetched"] += 1
            yield chunk


# -------------------------------------------------------------- the runtime
class PlacementRuntime:
    """ONE serve loop over any (DecisionEngine, ExecutionBackend) pair.

    Owns one predicted edge-queue horizon per fleet device. ``Simulation``
    (twin backend) and ``LivePlacementServer`` (live executor pool) are thin
    wrappers over this class.
    """

    def __init__(self, engine: DecisionEngine, backend: ExecutionBackend,
                 retry: RetryPolicy | None = None,
                 admission: AdmissionPolicy | None = None,
                 breaker: CircuitBreaker | None = None,
                 prewarm: PrewarmPolicy | None = None,
                 reclamation: ReclamationPolicy | None = None):
        self.engine = engine
        self.backend = backend
        self.stream_stats: dict | None = None  # last serve_stream aggregate
        self.edge_queues = {n: PredictedEdgeQueue() for n in engine.edge_names}
        # cloud-only runtimes keep a zeroed queue behind the deprecated
        # ``edge_queue`` alias, matching the attribute's pre-fleet existence
        self._no_edge_queue = PredictedEdgeQueue()
        # failure-aware serving (see ``repro_torch.core.faults``). All three knobs
        # default to off, which takes EXACTLY the pre-fault serve paths; with
        # them set but nothing failing/shedding, the round-0 dispatch is the
        # identical backend call, so an empty FaultSpec stays bit-identical.
        self.retry = retry
        self.admission = admission
        self.health = TargetHealth(breaker) if breaker is not None else None
        self._failure_aware = (retry is not None or admission is not None
                               or breaker is not None)
        self._pre_horizons: dict[str, float] | None = None
        # overload survival (see ``repro_torch.core.overload``): predictive
        # container pre-warming and/or fair-share tier reclamation. Both off
        # (the default) takes EXACTLY the pre-overload serve paths —
        # ``self.overload is None`` gates every hook.
        self.overload = (OverloadManager(prewarm, reclamation)
                         if prewarm is not None or reclamation is not None
                         else None)

    @property
    def edge_name(self) -> str:
        return self.engine.edge_name

    @property
    def edge_names(self) -> tuple[str, ...]:
        return self.engine.edge_names

    @property
    def edge_queue(self) -> PredictedEdgeQueue:
        """Deprecated single-edge alias for the first device's queue."""
        names = self.edge_names
        return self.edge_queues[names[0]] if names else self._no_edge_queue

    def serve(self, tasks: list[TaskInput], batched: bool = True) -> SimulationResult:
        """Place and execute a workload; aggregate the per-task records.

        ``batched=True`` (default) runs the columnar serve path: one
        vectorized prediction pass, the columnar decision core
        (``DecisionEngine.place_many`` → ``DecisionBatch``) and, when the
        backend implements ``execute_many``, one batched ground-truth pass
        whose outcome arrays land directly in a ``RecordBatch`` — array-native
        from prediction to result. ``batched=False`` interleaves per-task
        placement and execution. The two paths produce identical results —
        placement is non-blocking, so execution never feeds back into decision
        state; the columnar decision core is bit-identical to the per-task
        walk (speculate-and-repair, see ``repro_torch.core.decision``); and the
        twin's batched sampler is bit-identical to its sequential one.
        """
        if batched:
            self._pre_place(tasks)
            self._snapshot_horizons()
            decisions = self.engine.place_many(tasks, edge_queues=self.edge_queues)
            records = self._execute_decisions(tasks, decisions)
            self._post_execute(records)
        else:
            # the per-task step path skips the overload hooks, exactly like
            # the failure machinery (both are columnar-batch features)
            records = [self.step(t) for t in tasks]
        return self.result(records)

    def serve_stream(self, workload, chunk_size: int = 65536,
                     keep_tasks: bool | None = None,
                     expected_tasks: int | None = None,
                     keep_inputs: bool = False,
                     array_backend: str | None = None,
                     device_residency: bool | None = None,
                     prefetch: bool | None = None,
                     device=None) -> SimulationResult:
        """Streaming chunked serve: the columnar pipeline over arrival chunks,
        carrying every piece of sequential state across chunk boundaries.

        ``workload`` may be a task sequence (``list[TaskInput]`` or a columnar
        ``TaskChunk``, sliced into ``chunk_size`` spans), an iterator of
        tasks, or an iterator of ready chunks (``PoissonWorkload.chunks`` /
        ``BurstyWorkload.chunks`` — the constant-memory spelling). Each chunk
        runs the exact batched path of ``serve(batched=True)``:
        ``predict_batch`` → the columnar decision core → ``execute_many``,
        with outcome columns merged into a ``RecordArena``.

        BIT-IDENTICAL to one-shot ``serve(batched=True)`` for EVERY chunk
        size (including ``chunk_size=1`` and boundaries landing inside a
        speculate-and-repair segment), because all five sequential state
        carriers live outside the chunk: the CIL (on the Predictor), the
        Alg. 1 surplus bank (on the policy), the predicted edge-queue
        horizons (on this runtime), the per-(substrate, leg) RNG streams and
        the ground-truth container pool / edge FIFO horizons (on the
        backend). Numpy Generators produce the same stream drawn in one block
        or per chunk, and every recurrence is a left fold restarting from a
        scalar — so chunking changes where passes pause, never what they
        compute. The parity is hypothesis-tested per record.

        Peak memory is O(chunk_size × targets) working set plus the O(n)
        result columns — never the O(n × targets) prediction matrices of the
        one-shot path. ``keep_tasks`` controls whether per-task objects are
        retained on the result (default: only when ``workload`` is already a
        materialized list; streamed sources drop them and the result backs
        its metrics with the arena's arrival/index columns).
        ``keep_inputs=True`` retains the task size/bytes feature columns on
        the result even in constant-memory mode, so the run can be exported
        as a replayable trace (``repro_torch.trace.capture``) without task objects.

        ``stream_stats`` afterwards reports ``{"chunks", "n", "spec_segments",
        "repairs", "walked"}`` aggregated over the stream, and the host-clock
        seconds spent placing (``place_s``: ``place_many``, which ends in the
        copy of the chunk's decisions to the host) and executing
        (``execute_s``: the backend, the records and the arena merge).
        ``expected_tasks`` is an optional arena-capacity hint (a known stream
        length skips the geometric-doubling overshoot — exact-size result
        columns).

        ``array_backend`` overrides the engine's chunk-pipeline backend for
        this stream only (``"numpy"`` / ``"torch"`` — see ``DecisionEngine``):
        ``serve_stream(..., array_backend="torch")`` runs every eligible chunk
        through ``repro_torch.core.torch_core`` and falls back per chunk
        exactly like the engine-level setting. ``device`` overrides the
        engine's device for this stream only (``"cpu"`` on request; ``None``
        keeps the engine's).

        On the torch backend two stream-level optimizations engage (see the
        ``torch_core`` module docstring for the full residency model):

        - ``device_residency`` (default on when eligible) keeps the
          sequential placement state (CIL pools, surplus bank, edge
          horizons) ON THE DEVICE across consecutive in-order chunks — chunk
          boundaries stop being host-device sync points; the host
          structures are materialized only at stream end, on fallback exits
          and for external readers (``torch_core.sync_engine``). Disabled
          automatically when admission control or failure-aware serving is
          configured (those read/mutate host placement state mid-stream).
        - ``prefetch`` (default on) double-buffers chunk staging: a
          transfer thread pulls chunk k+1 from the workload iterator and
          copies its task columns to the device while chunk k places.

        ``stream_stats["residency"]`` afterwards reports the resident-chunk
        / sync / prefetch counters for this stream, the walks run again
        after a pool overflow (``pool_regrows``), and ``fallback_chunks``,
        the chunks that took the numpy path.
        """
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if keep_tasks is None:
            keep_tasks = isinstance(workload, (list, tuple))
        eng = self.engine
        was_backend = eng.array_backend
        was_device = eng.device
        if array_backend is not None:
            if array_backend not in ARRAY_BACKENDS:
                raise ValueError(
                    f"array_backend must be 'numpy' or 'torch', "
                    f"got {array_backend!r}")
        if device is not None:
            eng.device = eng.predictor.device = resolve_device(device)
        if array_backend is not None:
            eng.array_backend = array_backend
        arena = RecordArena(keep_tasks=keep_tasks,
                            capacity=expected_tasks or 0,
                            keep_inputs=keep_inputs)
        stats = {"chunks": 0, "n": 0, "spec_segments": 0, "repairs": 0,
                 "walked": 0, "place_s": 0.0, "execute_s": 0.0}
        use_device = eng.array_backend == "torch"
        residency = (use_device
                     and (device_residency is None or device_residency)
                     and self.admission is None and not self._failure_aware
                     and self.overload is None)
        do_prefetch = (use_device
                       and (prefetch is None or prefetch)
                       and not eng.record_decisions)
        pf = {"prefetched": 0}
        base: dict = {}
        if use_device:
            c0 = _engine_core(eng)
            if c0 is not None:
                base = {"state_syncs": c0.state_syncs,
                        "fallback_syncs": c0.fallback_syncs,
                        "resident_chunks": c0.resident_chunks,
                        "chunk_commits": c0.chunk_commits,
                        "pool_regrows": c0.pool_regrows}
            base["fallback_chunks"] = eng.fallback_chunks
            if residency:
                eng.__dict__["_device_residency"] = True
        chunk_iter = _iter_chunks(workload, chunk_size)
        if do_prefetch:
            chunk_iter = _prefetched_chunks(chunk_iter, eng, pf)
        prev_last = -np.inf
        force_walk = False
        try:
            for chunk in chunk_iter:
                m = len(chunk)
                if m == 0:
                    continue
                first = float(chunk[0].arrival_ms)
                last = float(chunk[m - 1].arrival_ms)
                if first < prev_last:
                    # the stream as a whole is out of arrival order: a
                    # columnar chunk would snapshot CIL state the one-shot
                    # walk has already reaped differently — from here on,
                    # every chunk must take the per-task walk (exactly what
                    # the one-shot path does)
                    force_walk = True
                prev_last = max(prev_last, last)
                was_columnar = eng.columnar
                eng.columnar_stats = None
                try:
                    if force_walk:
                        eng.columnar = False
                    self._pre_place(chunk)
                    self._snapshot_horizons()
                    t0 = time.perf_counter()
                    decisions = eng.place_many(
                        chunk, edge_queues=self.edge_queues)
                    t1 = time.perf_counter()
                finally:
                    eng.columnar = was_columnar
                recs = self._execute_decisions(chunk, decisions)
                arena.append(recs)
                self._post_execute(recs)
                stats["place_s"] += t1 - t0
                stats["execute_s"] += time.perf_counter() - t1
                stats["chunks"] += 1
                stats["n"] += m
                cs = eng.columnar_stats
                if cs is not None:
                    stats["spec_segments"] += cs["chunks"]
                    stats["repairs"] += cs["repairs"]
                    stats["walked"] += cs["walked"]
                else:
                    stats["walked"] += m
        finally:
            if use_device:
                eng.__dict__.pop("_device_residency", None)
                eng.__dict__.pop("_torch_staged", None)
                core = _engine_core(eng)
                if core is not None:
                    core.sync_host("stream_end")
            eng.array_backend = was_backend
            eng.device = eng.predictor.device = was_device
        if use_device:
            core = _engine_core(eng)
            if core is not None:
                stats["residency"] = {
                    "enabled": residency,
                    "resident_chunks": core.resident_chunks
                    - base.get("resident_chunks", 0),
                    "state_syncs": core.state_syncs
                    - base.get("state_syncs", 0),
                    "fallback_syncs": core.fallback_syncs
                    - base.get("fallback_syncs", 0),
                    "chunk_commits": core.chunk_commits
                    - base.get("chunk_commits", 0),
                    "pool_regrows": core.pool_regrows
                    - base.get("pool_regrows", 0),
                    "prefetched": pf["prefetched"]}
            stats.setdefault("residency", {})["fallback_chunks"] = \
                eng.fallback_chunks - base["fallback_chunks"]
        self.stream_stats = stats
        return self.result(arena.finish())

    def serve_async(self, tasks: list[TaskInput]) -> SimulationResult:
        """The event-driven serve: place like ``serve(batched=True)``, then
        execute through the backend's concurrent runner.

        Placement is non-blocking (decisions come from predicted state only),
        so the decision pass is exactly the batched columnar one; execution
        then fans out to per-target workers — ``TwinBackend`` interleaves
        them on the virtual-clock event heap (``repro_torch.core.events``), a live
        backend runs them as real threads so fleet executions genuinely
        overlap. A columnar ``DecisionBatch`` stays object-free end-to-end:
        workers pull rows by ``target_codes`` and the outcome arrays merge
        straight into a ``RecordBatch``. Hedged (list) decisions become race
        events — primary and hedge legs dispatched together, first completion
        wins, the loser drained (twin) or cancelled when it never started
        (live). On ``TwinBackend`` the result is METRIC-IDENTICAL to
        ``serve(batched=True)`` — asserted in tests; backends without an
        ``execute_async`` runner serve the same plan synchronously.

        Spans (``repro_torch.spans``, when recording): ``serve.slice`` over
        ``serve.place`` (the decision pass), ``serve.execute`` (the runner;
        a live pool's workers hang their ``pool.dispatch`` under it) and
        ``serve.records``.
        """
        with spans.span("serve.slice", tasks=len(tasks)):
            with spans.span("serve.place"):
                self._pre_place(tasks)
                self._snapshot_horizons()
                decisions = self.engine.place_many(
                    tasks, edge_queues=self.edge_queues)
            run = getattr(self.backend, "execute_async", None)
            reclaiming = (self.overload is not None
                          and self.overload.reclamation is not None)
            eb = None
            with spans.span("serve.execute"):
                if run is None or ((self._failure_aware or reclaiming)
                                   and isinstance(decisions, DecisionBatch)):
                    # the failure-aware runner issues the identical dispatch
                    # rounds from every serve path (the twin's async runner
                    # routes faulted runs through execute_many anyway — see
                    # ``execute_async``)
                    records = self._execute_decisions(tasks, decisions)
                elif isinstance(decisions, DecisionBatch):
                    eb = run(tasks, decisions
                             if getattr(self.backend, "accepts_decision_batch",
                                        False)
                             else decisions.target_list())
                else:
                    records = self._race_decisions(tasks, decisions, run)
            with spans.span("serve.records"):
                if eb is not None:
                    records = self._record_batch(tasks, decisions, eb) \
                        if isinstance(eb, ExecutionBatch) \
                        else [self._record(t, d, d.target, d.prediction, o)
                              for t, d, o in zip(tasks, decisions, eb)]
                self._post_execute(records)
                return self.result(records)

    def _race_decisions(self, tasks: list[TaskInput], decisions,
                        run) -> list[TaskRecord]:
        """Async-execute list decisions; hedge duplicates are race events."""
        d_tasks, d_targets, races = self._hedge_plan(tasks, decisions)
        eb = run(d_tasks, d_targets, races=races)
        return self._merge_hedged_outcomes(tasks, decisions, eb)

    @staticmethod
    def _hedge_plan(tasks: list[TaskInput], decisions,
                    ) -> tuple[list[TaskInput], list[str], list[tuple[int, int]]]:
        """One dispatch per execution leg, hedge duplicates right after their
        primary — the same order the sequential loop executes them in.
        ``races`` pairs each primary's dispatch index with its hedge's."""
        d_tasks: list[TaskInput] = []
        d_targets: list[str] = []
        races: list[tuple[int, int]] = []
        for t, d in zip(tasks, decisions):
            d_tasks.append(t)
            d_targets.append(d.target)
            if d.hedge_target is not None and d.hedge_target != d.target:
                races.append((len(d_tasks) - 1, len(d_tasks)))
                d_tasks.append(t)
                d_targets.append(d.hedge_target)
        return d_tasks, d_targets, races

    def _merge_hedged_outcomes(self, tasks: list[TaskInput], decisions,
                               outcomes) -> list[TaskRecord]:
        """Walk ``_hedge_plan``-ordered outcomes back into one record per
        task, resolving hedge races. ``outcomes`` is anything indexable to
        ``ExecutionOutcome``; a ``cancelled`` array (concurrent runners)
        marks legs that never ran."""
        flags = getattr(outcomes, "cancelled", None)
        records, j = [], 0
        for t, d in zip(tasks, decisions):
            pj = j
            j += 1
            if d.hedge_target is None or d.hedge_target == d.target:
                records.append(
                    self._record(t, d, d.target, d.prediction, outcomes[pj]))
                continue
            hj = j
            j += 1
            if flags is not None and bool(flags[pj]):
                # the race resolved to the HEDGE: the primary never started —
                # the record reports the leg that actually ran (its target,
                # actuals, device occupancy), with the cancelled primary as
                # the zero-occupancy duplicate; predicted stays the
                # decision-time expectation of racing both legs
                rec = self._record(t, d, d.hedge_target, d.hedge_prediction,
                                   outcomes[hj])
                rec.predicted_latency_ms = min(d.prediction.latency_ms,
                                               d.hedge_prediction.latency_ms)
                rec.predicted_cost = d.prediction.cost + d.hedge_prediction.cost
                rec.hedged = True
                rec.hedge_target = d.target
                records.append(rec)
                continue
            rec = self._record(t, d, d.target, d.prediction, outcomes[pj])
            cancelled = flags is not None and bool(flags[hj])
            records.append(self._merge_hedge(rec, t, d, outcomes[hj],
                                             cancelled=cancelled))
        return records

    def step(self, task: TaskInput) -> TaskRecord:
        """Place and execute one task (the per-task serve path)."""
        now = task.arrival_ms
        waits = {n: q.wait_ms(now) for n, q in self.edge_queues.items()}
        d = self.engine.place(task, now, edge_waits=waits)
        if d.target in self.edge_queues:
            self.edge_queues[d.target].push(now, d.prediction.comp_ms)
        if d.hedge_target is not None and d.hedge_target in self.edge_queues \
                and d.hedge_prediction is not None:
            self.edge_queues[d.hedge_target].push(now, d.hedge_prediction.comp_ms)
        return self._run_decision(task, d)

    def result(self, records: "RecordBatch | list[TaskRecord]") -> SimulationResult:
        cons = self.engine.policy.constraints()
        names = self.edge_names
        return SimulationResult(records=records, deadline_ms=cons.deadline_ms,
                                c_max=cons.c_max,
                                edge_name=names[0] if names else self.engine.edge_name,
                                edge_names=names or None)

    # ------------------------------------------------------------------
    def _execute_decisions(self, tasks: list[TaskInput], decisions,
                           ) -> "RecordBatch | list[TaskRecord]":
        """Execute a placed workload; vectorized when the backend supports it.

        A columnar ``DecisionBatch`` against a vectorized backend never leaves
        array land: decisions flow into ``execute_many`` and the outcome
        arrays zip straight into a ``RecordBatch`` — no ``PlacementDecision``,
        ``ExecutionOutcome`` or ``TaskRecord`` objects anywhere on the path.
        List decisions (hedged/custom policies, per-task backends) take the
        per-record path unchanged.
        """
        if isinstance(decisions, DecisionBatch):
            if self._failure_aware or (self.overload is not None and
                                       self.overload.reclamation is not None):
                return self._execute_failure_aware(tasks, decisions)
            if hasattr(self.backend, "execute_many"):
                eb = self.backend.execute_many(
                    tasks, decisions
                    if getattr(self.backend, "accepts_decision_batch", False)
                    else decisions.target_list())
                if isinstance(eb, ExecutionBatch):
                    return self._record_batch(tasks, decisions, eb)
                return [self._record(t, d, d.target, d.prediction, o)
                        for t, d, o in zip(tasks, decisions, eb)]
            # per-task backend: iterate the lazy decision views
            return [self._run_decision(t, d) for t, d in zip(tasks, decisions)]
        if not hasattr(self.backend, "execute_many"):
            return [self._run_decision(t, d) for t, d in zip(tasks, decisions)]
        d_tasks, d_targets, _ = self._hedge_plan(tasks, decisions)
        outcomes = self.backend.execute_many(d_tasks, d_targets)
        return self._merge_hedged_outcomes(tasks, decisions, outcomes)

    # ------------------------------------------------- overload survival
    def _pre_place(self, tasks) -> None:
        """Predictive pre-warming hook, called right before each placement
        pass (per chunk on the streaming path): feed the chunk's arrival
        gaps to the burst forecaster and spawn warm containers for every
        trigger it fires. Runs BEFORE ``place_many`` so the prewarmed pool
        is visible to the Predictor's warm/cold split for every row whose
        arrival falls inside a keep-alive window (earlier rows see the
        container as still spinning up — ``busy_until`` in the future — and
        are unaffected, so spawn position inside the batch doesn't matter).
        No-op unless pre-warming is armed."""
        ov = self.overload
        if ov is None or ov.prewarm is None or len(tasks) == 0:
            return
        _, arrivals, _, _ = task_arrays(tasks, "a")
        ov.reap_prewarms(float(arrivals[0]))
        for t in ov.feed_arrivals(arrivals):
            self._spawn_prewarm(t)

    def _spawn_prewarm(self, trigger_ms: float) -> None:
        """Spawn ``count`` keep-alive containers per target for one burst
        trigger: CIL record (client-side shadow), ground-truth spinup (twin
        backends), and the idle-retainer debit from the Alg. 1 surplus bank
        — billed exactly once per container, at spawn. Keep-alive extensions
        (``_post_execute``) ride the same retainer and are not re-billed."""
        ov = self.overload
        pw = ov.prewarm
        eng = self.engine
        predictor = eng.predictor
        targets = pw.targets if pw.targets is not None \
            else tuple(t.name for t in predictor.cloud_targets)
        spin = pw.spinup_ms
        if spin is None:
            spec = getattr(getattr(self.backend, "twin", None), "spec", None)
            spin = float(spec.cold_mean) if spec is not None else 250.0
        ready = trigger_ms + spin
        expires = ready + pw.keepalive_ms
        pol = eng.policy
        gt = getattr(self.backend, "gt_cloud", None)
        pricing = getattr(self.backend, "pricing", None)
        for nm in targets:
            cost = 0.0
            if pricing is not None:
                try:
                    # the retainer: billed occupancy over spinup + keep-alive
                    cost = float(pricing.cost(spin + pw.keepalive_ms,
                                              float(nm)))
                except (TypeError, ValueError):
                    cost = 0.0  # non-numeric config names price as free
            for _ in range(pw.count):
                rec = predictor.prewarm(nm, ready, expires)
                if gt is not None:
                    gt.spinup(nm, ready, expires)
                if hasattr(pol, "surplus"):
                    pol.surplus -= cost
                ov.record_spawn(trigger_ms, nm, ready, expires, cost, rec)

    def _post_execute(self, records) -> None:
        """Completion-stream keep-alive hook, called after each execution
        round: while the forecaster still sees the burst regime, push the
        keep-alive expiry of every still-unused prewarmed container out to
        (latest completion + keepalive_ms). Unbilled — the spawn-time
        retainer covers extensions (documented pricing simplification)."""
        ov = self.overload
        if ov is None or ov.prewarm is None or not ov.active_prewarms:
            return
        fc = ov.forecaster
        if fc is None or not fc.in_burst:
            return
        comp = records.completion_ms if isinstance(records, RecordBatch) \
            else np.array([r.completion_ms for r in records])
        if comp.size == 0:
            return
        new_exp = float(np.max(comp)) + ov.prewarm.keepalive_ms
        gt = getattr(self.backend, "gt_cloud", None)
        t_idl = self.engine.predictor.cil.t_idl_ms
        for e in ov.active_prewarms:
            if new_exp <= e.expires_ms:
                continue
            if e.cil_rec.busy_until != e.ready_ms:
                continue  # reused: the normal lifecycle owns it now
            e.cil_rec.last_completion = new_exp - t_idl
            if gt is not None:
                gt.extend_keepalive(e.target, e.ready_ms, e.expires_ms,
                                    new_exp)
            e.expires_ms = new_exp
            ov.n_extensions += 1

    # ------------------------------------------------- failure-aware serving
    def _snapshot_horizons(self) -> None:
        """Snapshot the predicted edge horizons right before ``place_many``
        so an admission shed (or a reclamation preemption) can unwind the
        queue pushes its placements made (``_rollback_shed``). No-op unless
        admission control or reclamation is configured."""
        if self.admission is not None or (
                self.overload is not None
                and self.overload.reclamation is not None):
            self._pre_horizons = {
                n: q.horizon_ms for n, q in self.edge_queues.items()}

    def _rollback_shed(self, tasks, d: DecisionBatch, shed: np.ndarray) -> None:
        """Unwind the decision-state side effects of shed placements.

        Surplus bank: the policy's ``observe`` banked ``c_max - cost`` for
        every placement; shed rows never execute, so their contributions are
        removed. Predicted edge horizons: restored to the pre-placement
        snapshot, then the SURVIVING edge pushes are replayed in arrival
        order — exactly the horizons a placement pass over the surviving set
        would have left. CIL reservations of shed rows are left to expire
        (conservative: the predictor may see phantom warmth for one idle
        window; a reservation never makes a later prediction worse than the
        truth by more than a warm/cold misjudgement).
        """
        pol = self.engine.policy
        if hasattr(pol, "surplus") and hasattr(pol, "c_max"):
            pol.surplus -= float(np.sum(pol.c_max - d.cost[shed]))
        if self._pre_horizons is None:
            return
        _, nows, _, _ = task_arrays(tasks, "a")
        for name, q in self.edge_queues.items():
            if name in self._pre_horizons:
                q.horizon_ms = self._pre_horizons[name]
        codes = d.target_codes
        replay = np.nonzero(~shed & (codes >= d.n_cloud))[0]
        for i in replay.tolist():
            q = self.edge_queues.get(d.names[int(codes[i])])
            if q is not None:
                q.push(float(nows[i]), float(d.comp_ms[i]))

    def _failover_place(self, task: TaskInput, now: float,
                        tried: set) -> "tuple[str, Prediction] | None":
        """Re-place a failed task at failure-detection time ``now``: re-enter
        the prediction pass against live CIL/queue state, mask the targets
        already tried plus any open circuits, and let the policy choose among
        the survivors (``failover_choice``). Applies the same decision-state
        accounting a placement does — surplus billed for the extra leg (the
        hedge precedent: an extra execution leg debits the bank), CIL
        reservation, predicted edge-queue push. Returns ``None`` when no
        surviving target remains."""
        eng = self.engine
        waits = {n: q.wait_ms(now) for n, q in self.edge_queues.items()}
        preds = eng.predictor.predict(task, now, edge_waits=waits)
        exclude = set(tried)
        h = self.health
        if h is not None:
            for nm in preds:
                if nm not in exclude and h.would_fail_fast(nm, now):
                    exclude.add(nm)
        choice = failover_choice(eng.policy, preds, exclude,
                                 self.edge_names, waits)
        if choice is None:
            return None
        name, pred = choice
        pol = eng.policy
        if hasattr(pol, "surplus"):
            pol.surplus -= pred.cost
        eng.predictor.update_cil(name, now, pred)
        if name in self.edge_queues:
            self.edge_queues[name].push(now, pred.comp_ms)
        return name, pred

    def _dispatch_rows(self, sub_tasks, targets) -> ExecutionBatch:
        """One dispatch round against the backend, normalized to columns.
        ``targets`` is whatever the backend's batched runner eats (a target
        list, or the full ``DecisionBatch`` on the round-0 fast path);
        per-task backends run the same round as sequential ``execute`` calls
        — the retry/timeout contract is identical either way."""
        em = getattr(self.backend, "execute_many", None)
        if em is not None:
            eb = em(sub_tasks, targets)
            if isinstance(eb, ExecutionBatch):
                return eb
            outs = list(eb)
        else:
            tl = targets if isinstance(targets, list) else targets.target_list()
            outs = [self.backend.execute(t, tg, t.arrival_ms)
                    for t, tg in zip(sub_tasks, tl)]
        return ExecutionBatch(
            latency_ms=np.array([o.latency_ms for o in outs]),
            cost=np.array([o.cost for o in outs]),
            cold=np.array([o.cold for o in outs], dtype=bool),
            completion_ms=np.array([o.completion_ms for o in outs]),
            queue_wait_ms=np.array([o.queue_wait_ms for o in outs]),
            exec_ms=np.array([o.exec_ms for o in outs]),
            failed=np.array([getattr(o, "failed", False) for o in outs],
                            dtype=bool),
            fail_kind=np.array([getattr(o, "fail_kind", 0) for o in outs],
                               dtype=np.int64))

    @staticmethod
    def _after_failure(pending: list, i: int, task: TaskInput, nm: str,
                       tf: float, attempts: int, tried: set, arrival: float,
                       kind: int, rp: RetryPolicy,
                       f_fail, f_comp, f_lat) -> None:
        """Route one failed dispatch: transient failures retry the SAME
        target after exponential backoff; fail-fast kinds (outage, blackout,
        breaker) fail over immediately at detection time; attempts exhausted
        or the failure detected past the timeout → permanent failure (the
        record keeps every attempted leg's cost, latency = give-up time)."""
        if attempts < rp.max_attempts and tf - arrival < rp.timeout_ms:
            if kind == TRANSIENT:
                pending.append([i, task, nm, tf + rp.backoff_for(attempts),
                                attempts, tried, arrival])
                return
            if rp.failover:
                pending.append([i, task, None, tf, attempts, tried, arrival])
                return
        f_fail[i] = True
        f_comp[i] = tf
        f_lat[i] = tf - arrival

    def _execute_failure_aware(self, tasks, d: DecisionBatch) -> RecordBatch:
        """The failure-aware batched runner: admission shed → round-0
        dispatch → retry / failover rounds, all on the virtual clock.

        Round 0 with nothing shed and no open circuit is the IDENTICAL
        backend call the plain batched path makes (the whole task container
        and ``DecisionBatch`` go straight to ``execute_many``), so an empty
        ``FaultSpec`` stays bit-identical per record with retry / admission /
        breaker configured. Every serve path (one-shot, streaming chunks,
        event-driven) funnels through this one runner, so the fault
        schedule, retry times, failover placements and shed set are
        identical across paths at a fixed chunking.

        Breaker health is evaluated against state as of the start of the
        batch and advanced in dispatch order within it — at round
        granularity, deterministically. Pending retries sort by (dispatch
        time, row) each round; failover placements resolve in that order
        against live CIL / queue state.
        """
        n = len(d)
        rp = self.retry if self.retry is not None else RetryPolicy()
        tiers = task_tiers(tasks)
        _, arrivals, _, _ = task_arrays(tasks, "a")
        names = d.names
        code_of = {nm: c for c, nm in enumerate(names)}
        codes = d.target_codes

        # --- SLO-tiered admission: shed sheddable rows whose predicted
        # latency blows the tier budget, then unwind their placement state
        shed = np.zeros(n, dtype=bool)
        if self.admission is not None:
            shed = self.admission.shed_mask(tiers, d.latency_ms)

        # --- fair-share reclamation (see ``repro_torch.core.overload``): when a
        # device's tier-0 predictions blow their deadline headroom, preempt
        # lower-tier rows already placed on it. Shed and victim placements
        # unwind in ONE combined rollback (victims are always edge rows, so
        # no CIL state is involved), then each victim re-places at its own
        # arrival time with its device masked (``_replace_victims``).
        recl = self.overload.reclamation if self.overload is not None else None
        downgraded = np.zeros(n, dtype=bool)
        pred_lat, pred_cost, pred_cold = d.latency_ms, d.cost, d.cold
        moved_any = False
        victims = np.zeros(0, dtype=np.int64)
        if recl is not None:
            tiers = np.asarray(tiers, dtype=np.int64).copy()
            victims = select_victims(
                recl, codes=codes, tier=tiers, latency_ms=d.latency_ms,
                comp_ms=d.comp_ms, active=~shed, n_cloud=d.n_cloud,
                n_targets=len(names))
        vict = np.zeros(n, dtype=bool)
        vict[victims] = True
        rollback = shed | vict
        if rollback.any():
            self._rollback_shed(tasks, d, rollback)
        if victims.size:
            codes = codes.copy()
            pred_lat = pred_lat.copy()
            pred_cost = pred_cost.copy()
            pred_cold = pred_cold.copy()
            comp = d.comp_ms.astype(np.float64, copy=True)
            moved_any = self._replace_victims(
                tasks, d, victims, recl, codes, tiers, downgraded,
                pred_lat, pred_cost, pred_cold, comp, arrivals)
            # exactness: a victim push appended after the survivor replay
            # escapes the max(horizon, t) drain-resets its in-order push
            # was subject to, so rebuild the horizons with one event-ordered
            # replay of the FINAL assignment — bit-identical to a fresh
            # placement pass over it.
            self._replay_final_pushes(d, shed, codes, comp, arrivals)

        # final per-row outcome columns; shed rows keep the zeroed defaults
        # (bill nothing, complete at arrival, zero attempts)
        f_lat = np.zeros(n)
        f_cost = np.zeros(n)
        f_cold = np.zeros(n, dtype=bool)
        f_comp = np.asarray(arrivals, dtype=np.float64).copy()
        f_qw = np.zeros(n)
        f_ex = np.zeros(n)
        f_code = codes.astype(np.int64, copy=True)
        f_att = np.zeros(n, dtype=np.int64)
        f_fail = np.zeros(n, dtype=bool)

        # --- circuit breaker: dispatches to open targets fail fast at
        # arrival (no draws, no occupancy) and go straight to failover
        health = self.health
        pending: list[list] = []  # [row, task, target|None, t, attempts, tried, arrival]
        blocked = np.zeros(n, dtype=bool)
        if health is not None and health.any_open():
            for i in range(n):
                if shed[i]:
                    continue
                nm = names[int(codes[i])]
                if health.is_open(nm, float(arrivals[i])):
                    blocked[i] = True
                    t0 = float(arrivals[i])
                    if rp.failover:
                        pending.append([i, tasks[i], None, t0, 0, {nm}, t0])
                    else:
                        f_fail[i] = True

        # --- round 0: the surviving placements, dispatched exactly like the
        # plain batched path (full batch = the identical backend call)
        skip = shed | blocked
        live = np.nonzero(~skip)[0]
        eb = None
        if live.size == n and not moved_any:
            eb = self._dispatch_rows(
                tasks, d
                if getattr(self.backend, "accepts_decision_batch", False)
                else d.target_list())
        elif live.size == n:
            # a victim moved off its device: same full-batch dispatch, but
            # through the revised target list (d's codes are stale)
            eb = self._dispatch_rows(
                tasks, [names[int(c)] for c in codes.tolist()])
        elif live.size:
            sub_tasks = [tasks[int(i)] for i in live]
            sub_targets = [names[int(codes[i])] for i in live]
            eb = self._dispatch_rows(sub_tasks, sub_targets)
        if eb is not None:
            f_lat[live] = eb.latency_ms
            f_cost[live] = eb.cost
            f_cold[live] = eb.cold
            f_comp[live] = eb.completion_ms
            f_qw[live] = eb.queue_wait_ms
            f_ex[live] = eb.exec_ms
            f_att[live] = 1

        fmask = eb.failed if eb is not None else None
        any_failed = fmask is not None and bool(fmask.any())
        if eb is not None and (any_failed
                               or (health is not None and health.dirty())):
            # walk round-0 outcomes in dispatch order: health bookkeeping +
            # retry/failover scheduling for the failed rows
            kinds = eb.fail_kind
            for j, i in enumerate(live.tolist()):
                nm = names[int(codes[i])]
                if fmask is not None and fmask[j]:
                    tf = float(eb.completion_ms[j])
                    if health is not None:
                        health.record_failure(nm, tf)
                    kind = int(kinds[j]) if kinds is not None else TRANSIENT
                    self._after_failure(pending, i, tasks[i], nm, tf, 1,
                                        {nm}, float(arrivals[i]), kind, rp,
                                        f_fail, f_comp, f_lat)
                elif health is not None:
                    health.record_success(nm)

        # --- retry / failover rounds (bounded by rp.max_attempts)
        while pending:
            pending.sort(key=lambda p: (p[3], p[0]))
            ready = []
            for p in pending:
                if p[2] is None:
                    choice = self._failover_place(p[1], p[3], p[5])
                    if choice is None:
                        f_fail[p[0]] = True
                        f_comp[p[0]] = p[3]
                        f_lat[p[0]] = p[3] - p[6]
                        continue
                    p[2] = choice[0]
                ready.append(p)
            if not ready:
                break
            sub_tasks = [TaskInput(idx=p[1].idx, arrival_ms=p[3],
                                   size=p[1].size, bytes=p[1].bytes,
                                   tier=getattr(p[1], "tier", 0))
                         for p in ready]
            reb = self._dispatch_rows(sub_tasks, [p[2] for p in ready])
            pending = []
            for j, p in enumerate(ready):
                i, nm = p[0], p[2]
                p[5].add(nm)
                p[4] += 1
                f_att[i] += 1
                f_cost[i] += float(reb.cost[j])
                f_ex[i] += float(reb.exec_ms[j])
                failed = bool(reb.failed[j]) if reb.failed is not None else False
                if not failed:
                    if health is not None:
                        health.record_success(nm)
                    f_fail[i] = False
                    f_code[i] = code_of.get(nm, f_code[i])
                    f_cold[i] = bool(reb.cold[j])
                    f_comp[i] = float(reb.completion_ms[j])
                    f_lat[i] = f_comp[i] - p[6]
                    f_qw[i] = float(reb.queue_wait_ms[j])
                    continue
                tf = float(reb.completion_ms[j])
                if health is not None:
                    health.record_failure(nm, tf)
                kind = int(reb.fail_kind[j]) if reb.fail_kind is not None \
                    else TRANSIENT
                self._after_failure(pending, i, p[1], nm, tf, p[4], p[5],
                                    p[6], kind, rp, f_fail, f_comp, f_lat)

        return RecordBatch(
            tasks=tasks,
            target_codes=f_code,
            target_names=names,
            predicted_latency_ms=pred_lat,
            predicted_cost=pred_cost,
            actual_latency_ms=f_lat,
            actual_cost=f_cost,
            predicted_cold=pred_cold,
            actual_cold=f_cold,
            allowed_cost=d.allowed_cost,
            feasible=d.feasible,
            completion_ms=f_comp,
            hedged=np.zeros(n, dtype=bool),
            queue_wait_ms=f_qw,
            exec_ms=f_ex,
            hedge_codes=np.full(n, -1, dtype=np.int64),
            hedge_exec_ms=np.zeros(n),
            task_idx=d.task_idx,
            shed=shed,
            failed=f_fail,
            attempts=f_att,
            tier=tiers,
            downgraded=downgraded,
        )

    def _replace_victims(self, tasks, d: DecisionBatch, victims: np.ndarray,
                         recl: ReclamationPolicy, codes: np.ndarray,
                         tiers: np.ndarray, downgraded: np.ndarray,
                         pred_lat: np.ndarray, pred_cost: np.ndarray,
                         pred_cold: np.ndarray, comp: np.ndarray,
                         arrivals) -> bool:
        """Re-place reclamation victims at their own arrival times, oldest
        first (PREEMPT events on the virtual-clock heap — ordered after any
        same-instant arrival), through the same masked ``failover_choice``
        path failovers use. Accounting is observe-style, NOT the failover
        debit: a victim executes exactly once, so its new placement banks
        ``c_max − cost`` exactly as a fresh placement would — the combined
        rollback already removed the old contribution, so surplus state ends
        exactly re-debited. A victim with every alternative excluded is kept
        in place (its original placement re-applied verbatim) and demoted
        one SLO class unconditionally — the platform owes it nothing at its
        old class; a moved victim is demoted only when the new placement
        blows its old tier's deadline headroom. Returns True when any
        victim actually moved (the round-0 fast path must then rebuild its
        target list). Mutates ``codes`` / ``tiers`` / ``downgraded`` /
        ``pred_*`` in place and appends to the manager's ``reclaim_log``."""
        eng = self.engine
        pol = eng.policy
        names = d.names
        code_of = {nm: c for c, nm in enumerate(names)}
        health = self.health
        ov = self.overload
        nt = len(recl.tiers)
        banks = hasattr(pol, "surplus") and hasattr(pol, "c_max")
        heap = EventHeap()
        for i in victims.tolist():
            heap.push(float(arrivals[i]), PREEMPT, i)
        moved_any = False
        for ev in heap.drain():
            i = ev.payload
            t0 = ev.time_ms
            src = names[int(codes[i])]
            old_tier = int(tiers[i])
            waits = {nm: q.wait_ms(t0) for nm, q in self.edge_queues.items()}
            preds = eng.predictor.predict(tasks[i], t0, edge_waits=waits)
            exclude = {src}
            if health is not None:
                for nm in preds:
                    if nm not in exclude and health.would_fail_fast(nm, t0):
                        exclude.add(nm)
            choice = failover_choice(pol, preds, exclude, self.edge_names,
                                     waits)
            if choice is not None:
                nm, pred = choice
                if banks:
                    pol.surplus += pol.c_max - pred.cost
                eng.predictor.update_cil(nm, t0, pred)
                if nm in self.edge_queues:
                    self.edge_queues[nm].push(t0, pred.comp_ms)
                codes[i] = code_of.get(nm, codes[i])
                pred_lat[i] = pred.latency_ms
                pred_cost[i] = pred.cost
                pred_cold[i] = pred.cold
                comp[i] = pred.comp_ms
                moved = True
                moved_any = True
                demote = pred.latency_ms \
                    > recl.deadline_of(old_tier) * recl.headroom
            else:
                if banks:
                    pol.surplus += pol.c_max - float(d.cost[i])
                if src in self.edge_queues:
                    self.edge_queues[src].push(t0, float(d.comp_ms[i]))
                nm = src
                moved = False
                demote = True
            if demote:
                tiers[i] = min(old_tier + 1, nt - 1)
            downgraded[i] = tiers[i] != old_tier
            ov.reclaim_log.append(
                (t0, int(d.task_idx[i]), src, nm, old_tier, int(tiers[i]),
                 moved, bool(downgraded[i])))
        return moved_any

    def _replay_final_pushes(self, d: DecisionBatch, shed: np.ndarray,
                             codes: np.ndarray, comp: np.ndarray,
                             arrivals) -> None:
        """Reset the predicted edge horizons to the pre-placement snapshot
        and replay the final assignment's edge pushes in arrival order —
        the horizons a single fresh placement pass over the post-reclamation
        assignment would have left. (The intermediate per-victim pushes in
        ``_replace_victims`` only shape the waits later victims predict
        against; this pass owns the state that crosses into the next chunk.)
        """
        if self._pre_horizons is None:
            return
        for name, q in self.edge_queues.items():
            if name in self._pre_horizons:
                q.horizon_ms = self._pre_horizons[name]
        replay = np.nonzero(~shed & (codes >= d.n_cloud))[0]
        for i in replay.tolist():
            q = self.edge_queues.get(d.names[int(codes[i])])
            if q is not None:
                q.push(float(arrivals[i]), float(comp[i]))

    def _record_batch(self, tasks: list[TaskInput], d: DecisionBatch,
                      eb: ExecutionBatch) -> RecordBatch:
        """Zip decision and outcome arrays into the columnar record store."""
        n = len(d)
        return RecordBatch(
            tasks=tasks,
            target_codes=d.target_codes,
            target_names=d.names,
            predicted_latency_ms=d.latency_ms,
            predicted_cost=d.cost,
            actual_latency_ms=eb.latency_ms,
            actual_cost=eb.cost,
            predicted_cold=d.cold,
            actual_cold=eb.cold,
            allowed_cost=d.allowed_cost,
            feasible=d.feasible,
            completion_ms=eb.completion_ms,
            hedged=np.zeros(n, dtype=bool),  # columnar policies never hedge
            queue_wait_ms=eb.queue_wait_ms,
            exec_ms=eb.exec_ms,
            hedge_codes=np.full(n, -1, dtype=np.int64),
            hedge_exec_ms=np.zeros(n),
            task_idx=d.task_idx,
            failed=eb.failed,
            tier=tasks.tier if isinstance(tasks, TaskChunk)
            else task_tiers(tasks),
        )

    def _run_decision(self, task: TaskInput, d: PlacementDecision) -> TaskRecord:
        now = task.arrival_ms
        rec = self._record(task, d, d.target, d.prediction,
                           self.backend.execute(task, d.target, now))
        # Hedged duplicate (beyond-paper): first completion wins, both billed.
        if d.hedge_target is not None and d.hedge_target != d.target:
            dup = self.backend.execute(task, d.hedge_target, now)
            rec = self._merge_hedge(rec, task, d, dup)
        return rec

    def _merge_hedge(self, rec: TaskRecord, task: TaskInput,
                     d: PlacementDecision, dup: ExecutionOutcome,
                     cancelled: bool = False) -> TaskRecord:
        """Resolve a hedge race: first completion wins, both legs billed.

        ``cancelled`` marks a duplicate a concurrent runner cancelled before
        it ever started (live only): it ran nowhere and bills nothing, so the
        primary's actuals stand alone — the *predicted* merge still reflects
        the decision-time expectation of racing both legs.

        Failed legs (fault injection) never win the race: a crashed primary
        falls to a surviving duplicate — the record reports the duplicate's
        target and actuals with the primary as the hedge leg — and a crashed
        duplicate leaves the primary standing; either way BOTH legs bill
        what they actually ran. Both crashed → a failed record on the
        primary, its failure-detection time as completion.
        """
        backup = d.hedge_prediction
        p_failed = rec.failed
        h_failed = (not cancelled) and bool(getattr(dup, "failed", False))
        p_lat = min(rec.predicted_latency_ms, backup.latency_ms)
        p_cost = rec.predicted_cost + backup.cost
        both_cost = rec.actual_cost + (0.0 if cancelled else dup.cost)
        if p_failed and not h_failed and not cancelled:
            # race resolved to the surviving duplicate
            return TaskRecord(
                task=task, target=d.hedge_target,
                predicted_latency_ms=p_lat, predicted_cost=p_cost,
                actual_latency_ms=dup.latency_ms, actual_cost=both_cost,
                predicted_cold=rec.predicted_cold, actual_cold=dup.cold,
                allowed_cost=rec.allowed_cost, feasible=rec.feasible,
                completion_ms=dup.completion_ms, hedged=True,
                queue_wait_ms=dup.queue_wait_ms, exec_ms=dup.exec_ms,
                hedge_target=rec.target, hedge_exec_ms=rec.exec_ms,
                tier=rec.tier,
            )
        alive = not p_failed and not h_failed and not cancelled
        return TaskRecord(
            task=task, target=rec.target,
            predicted_latency_ms=p_lat,
            predicted_cost=p_cost,
            actual_latency_ms=min(rec.actual_latency_ms, dup.latency_ms)
            if alive else rec.actual_latency_ms,
            actual_cost=both_cost,
            predicted_cold=rec.predicted_cold, actual_cold=rec.actual_cold,
            allowed_cost=rec.allowed_cost, feasible=rec.feasible,
            completion_ms=min(rec.completion_ms, dup.completion_ms)
            if alive else rec.completion_ms, hedged=True,
            queue_wait_ms=rec.queue_wait_ms, exec_ms=rec.exec_ms,
            hedge_target=d.hedge_target,
            hedge_exec_ms=0.0 if cancelled else dup.exec_ms,
            failed=p_failed and (cancelled or h_failed),
            tier=rec.tier,
        )

    def _record(self, task: TaskInput, d: PlacementDecision, target: str,
                pred: Prediction, out: ExecutionOutcome) -> TaskRecord:
        return TaskRecord(
            task=task, target=target,
            predicted_latency_ms=pred.latency_ms, predicted_cost=pred.cost,
            actual_latency_ms=out.latency_ms, actual_cost=out.cost,
            predicted_cold=pred.cold, actual_cold=out.cold,
            allowed_cost=d.allowed_cost, feasible=d.feasible,
            completion_ms=out.completion_ms,
            queue_wait_ms=out.queue_wait_ms, exec_ms=out.exec_ms,
            failed=bool(getattr(out, "failed", False)),
            tier=getattr(task, "tier", 0),
        )
