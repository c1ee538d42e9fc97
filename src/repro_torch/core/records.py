"""Per-task records and aggregate results of a placement run — columnar.

``RecordBatch`` is the struct-of-arrays home of a run's outcomes: one float64
column per field instead of N ``TaskRecord`` objects, which is what keeps
million-task serves practical (no per-task object churn, metrics computed as
array reductions). ``TaskRecord`` survives as the lazy per-task view —
``batch[i]`` materializes one on demand, so existing per-record consumers keep
working unchanged.

``SimulationResult`` aggregates a run's batch into the paper's reported
metrics (Tables III-V), all evaluated on the arrays. Both types are
substrate-agnostic: the same columns describe an event-driven simulation
against the AWS twin and a live prototype run over real executors (see
``repro_torch.core.runtime``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.workload import TaskChunk, TaskInput


@dataclass
class TaskRecord:
    task: TaskInput
    target: str
    predicted_latency_ms: float
    predicted_cost: float
    actual_latency_ms: float
    actual_cost: float
    predicted_cold: bool
    actual_cold: bool
    allowed_cost: float
    feasible: bool
    completion_ms: float
    hedged: bool = False
    queue_wait_ms: float = 0.0  # actual FIFO wait on the executor (edge)
    exec_ms: float = 0.0        # executor busy occupancy (utilization)
    hedge_target: str | None = None  # where the duplicate dispatch ran
    hedge_exec_ms: float = 0.0       # its busy occupancy (for device load)
    # failure-aware serving (see ``repro_torch.core.faults``): shed tasks never ran
    # (bill nothing); failed tasks exhausted retry/failover; ``attempts``
    # counts every dispatch billed to this task; ``tier`` is its SLO class
    shed: bool = False
    failed: bool = False
    attempts: int = 1
    tier: int = 0
    # fair-share reclamation demoted this task to a lower SLO class
    # (``tier`` holds the FINAL, post-demotion class)
    downgraded: bool = False

    @property
    def warm_cold_mismatch(self) -> bool:
        return self.target != "edge" and self.predicted_cold != self.actual_cold


@dataclass(eq=False)
class RecordBatch(Sequence):
    """Struct-of-arrays form of N ``TaskRecord``s (the columnar record path).

    ``target_codes`` indexes into ``target_names``; ``hedge_codes`` uses the
    same table with ``-1`` meaning "no hedge". Indexing or iterating yields
    lazy ``TaskRecord`` views; metrics should use the arrays directly.

    ``tasks`` may be a ``list[TaskInput]``, a columnar ``TaskChunk``, or —
    for streaming serves that drop per-task objects entirely
    (``serve_stream(keep_tasks=False)``) — empty, in which case the
    ``arrivals``/``task_idx`` columns back the metrics and ``__getitem__``
    synthesizes placeholder tasks (``meta={"streamed": True}``, NaN sizes).
    """

    tasks: "list[TaskInput] | TaskChunk"
    target_codes: np.ndarray        # (n,) int64 — index into target_names
    target_names: tuple[str, ...]
    predicted_latency_ms: np.ndarray
    predicted_cost: np.ndarray
    actual_latency_ms: np.ndarray
    actual_cost: np.ndarray
    predicted_cold: np.ndarray      # bool
    actual_cold: np.ndarray         # bool
    allowed_cost: np.ndarray
    feasible: np.ndarray            # bool
    completion_ms: np.ndarray
    hedged: np.ndarray              # bool
    queue_wait_ms: np.ndarray
    exec_ms: np.ndarray
    hedge_codes: np.ndarray         # (n,) int64, -1 = no hedge
    hedge_exec_ms: np.ndarray
    # streaming columns (set when per-task objects are dropped; see class doc)
    arrivals: np.ndarray | None = None
    task_idx: np.ndarray | None = None
    # input columns (set by ``RecordArena(keep_inputs=True)``): the task
    # size/bytes features, retained so a streamed run with no task objects is
    # still exportable as a replayable trace (``repro_torch.trace.capture``)
    input_size: np.ndarray | None = None
    input_bytes: np.ndarray | None = None
    # failure-aware serving columns (``None`` at construction materializes
    # the no-failure defaults, so every existing producer stays valid):
    # shed = admission control dropped the task (it bills nothing), failed =
    # retries/failovers exhausted, attempts = dispatches billed, tier = SLO
    # class (0 = highest). See ``repro_torch.core.faults``.
    shed: np.ndarray | None = None      # bool
    failed: np.ndarray | None = None    # bool
    attempts: np.ndarray | None = None  # int64, >= 1 (0 for shed rows)
    tier: np.ndarray | None = None      # int64
    # reclamation demoted the task's SLO class (``tier`` is the final class)
    downgraded: np.ndarray | None = None  # bool

    def __post_init__(self):
        n = self.target_codes.shape[0]
        if self.shed is None:
            self.shed = np.zeros(n, dtype=bool)
        if self.failed is None:
            self.failed = np.zeros(n, dtype=bool)
        if self.attempts is None:
            self.attempts = np.ones(n, dtype=np.int64)
        if self.tier is None:
            self.tier = np.zeros(n, dtype=np.int64)
        if self.downgraded is None:
            self.downgraded = np.zeros(n, dtype=bool)

    # ------------------------------------------------------------ construction
    @classmethod
    def empty(cls) -> "RecordBatch":
        z = np.zeros(0)
        zb = np.zeros(0, dtype=bool)
        zi = np.zeros(0, dtype=np.int64)
        return cls(tasks=[], target_codes=zi, target_names=(),
                   predicted_latency_ms=z, predicted_cost=z,
                   actual_latency_ms=z, actual_cost=z,
                   predicted_cold=zb, actual_cold=zb,
                   allowed_cost=z, feasible=zb, completion_ms=z,
                   hedged=zb, queue_wait_ms=z, exec_ms=z,
                   hedge_codes=zi, hedge_exec_ms=z)

    @classmethod
    def from_records(cls, records: Sequence[TaskRecord]) -> "RecordBatch":
        """Columnarize a list of per-task records (the object-path adapter)."""
        if isinstance(records, cls):
            return records
        records = list(records)
        if not records:
            return cls.empty()
        names = dict.fromkeys(r.target for r in records)
        names.update(dict.fromkeys(
            r.hedge_target for r in records if r.hedge_target is not None))
        table = tuple(names)
        code = {nm: i for i, nm in enumerate(table)}
        return cls(
            tasks=[r.task for r in records],
            target_codes=np.array([code[r.target] for r in records], np.int64),
            target_names=table,
            predicted_latency_ms=np.array([r.predicted_latency_ms for r in records]),
            predicted_cost=np.array([r.predicted_cost for r in records]),
            actual_latency_ms=np.array([r.actual_latency_ms for r in records]),
            actual_cost=np.array([r.actual_cost for r in records]),
            predicted_cold=np.array([r.predicted_cold for r in records], bool),
            actual_cold=np.array([r.actual_cold for r in records], bool),
            allowed_cost=np.array([r.allowed_cost for r in records]),
            feasible=np.array([r.feasible for r in records], bool),
            completion_ms=np.array([r.completion_ms for r in records]),
            hedged=np.array([r.hedged for r in records], bool),
            queue_wait_ms=np.array([r.queue_wait_ms for r in records]),
            exec_ms=np.array([r.exec_ms for r in records]),
            hedge_codes=np.array(
                [code[r.hedge_target] if r.hedge_target is not None else -1
                 for r in records], np.int64),
            hedge_exec_ms=np.array([r.hedge_exec_ms for r in records]),
            shed=np.array([r.shed for r in records], bool),
            failed=np.array([r.failed for r in records], bool),
            attempts=np.array([r.attempts for r in records], np.int64),
            tier=np.array([r.tier for r in records], np.int64),
            downgraded=np.array([r.downgraded for r in records], bool),
        )

    # ------------------------------------------------------------- sequence API
    def __len__(self) -> int:
        return self.target_codes.shape[0]

    def __bool__(self) -> bool:
        return len(self) > 0

    def _task_at(self, i: int) -> TaskInput:
        if len(self.tasks) > 0:
            return self.tasks[i]
        # streamed batch: the tasks were never retained — synthesize a
        # placeholder carrying what the record columns know
        return TaskInput(
            idx=int(self.task_idx[i]) if self.task_idx is not None else i,
            arrival_ms=float(self.arrivals[i]) if self.arrivals is not None else 0.0,
            size=float(self.input_size[i]) if self.input_size is not None
            else float("nan"),
            bytes=float(self.input_bytes[i]) if self.input_bytes is not None
            else float("nan"),
            meta={"streamed": True})

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = int(i)
        hc = int(self.hedge_codes[i])
        return TaskRecord(
            task=self._task_at(i),
            target=self.target_names[int(self.target_codes[i])],
            predicted_latency_ms=float(self.predicted_latency_ms[i]),
            predicted_cost=float(self.predicted_cost[i]),
            actual_latency_ms=float(self.actual_latency_ms[i]),
            actual_cost=float(self.actual_cost[i]),
            predicted_cold=bool(self.predicted_cold[i]),
            actual_cold=bool(self.actual_cold[i]),
            allowed_cost=float(self.allowed_cost[i]),
            feasible=bool(self.feasible[i]),
            completion_ms=float(self.completion_ms[i]),
            hedged=bool(self.hedged[i]),
            queue_wait_ms=float(self.queue_wait_ms[i]),
            exec_ms=float(self.exec_ms[i]),
            hedge_target=self.target_names[hc] if hc >= 0 else None,
            hedge_exec_ms=float(self.hedge_exec_ms[i]),
            shed=bool(self.shed[i]),
            failed=bool(self.failed[i]),
            attempts=int(self.attempts[i]),
            tier=int(self.tier[i]),
            downgraded=bool(self.downgraded[i]),
        )

    def __iter__(self) -> Iterator[TaskRecord]:
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------------- array views
    @cached_property
    def arrival_ms(self) -> np.ndarray:
        if self.arrivals is not None:
            return self.arrivals
        if isinstance(self.tasks, TaskChunk):
            return self.tasks.arrival_ms
        return np.array([t.arrival_ms for t in self.tasks])

    @property
    def targets(self) -> np.ndarray:
        """Per-row target names as an object array (diagnostics, benches)."""
        return np.array(self.target_names, dtype=object)[self.target_codes] \
            if self.target_names else np.empty(0, dtype=object)

    def code_of(self, name: str) -> int:
        """Code for ``name`` in this batch's table, -1 if never used."""
        try:
            return self.target_names.index(name)
        except ValueError:
            return -1

    def target_mask(self, names: set[str] | frozenset[str]) -> np.ndarray:
        """Boolean mask of rows whose target is in ``names`` (vectorized)."""
        table = np.array([nm in names for nm in self.target_names], bool)
        if table.shape[0] == 0:
            return np.zeros(len(self), bool)
        return table[self.target_codes]

    def completion_order(self) -> np.ndarray:
        """Row indices sorted by completion time (ties keep arrival order).

        Rows are stored in arrival order, but the event-driven runtime
        *finishes* them in completion order — this is the batch as the
        completion-event stream saw it, the natural replay order for
        consumers that react to outcomes (online refit of the component
        models, drift monitors) rather than to arrivals.
        """
        return np.argsort(self.completion_ms, kind="stable")

    def input_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The ``(size, bytes)`` input-feature columns of this batch's tasks.

        Used by trace capture (``repro_torch.trace.capture``) to make any serve run
        re-replayable. Prefers the dedicated input columns (streamed runs with
        ``keep_inputs=True``), then the retained task container. Raises an
        actionable ``ValueError`` when the inputs were dropped entirely.
        """
        if self.input_size is not None and self.input_bytes is not None:
            return self.input_size, self.input_bytes
        if isinstance(self.tasks, TaskChunk):
            return self.tasks.size, self.tasks.bytes
        if len(self.tasks) > 0:
            return (np.array([t.size for t in self.tasks], dtype=np.float64),
                    np.array([t.bytes for t in self.tasks], dtype=np.float64))
        if len(self) == 0:
            return np.zeros(0), np.zeros(0)
        raise ValueError(
            "task input sizes were not retained on this batch — re-run with "
            "serve_stream(..., keep_inputs=True) (constant-memory streams) or "
            "keep_tasks=True so the run can be captured as a replayable trace")

    def take(self, order) -> "RecordBatch":
        """Rows reordered/selected by an index array, as a new batch.

        Every column (including the optional streaming/input columns) is
        gathered through the same index, so ``take(completion_order())`` is
        the completion-event view and cross-shard merges can re-sort into
        global arrival order (``ShardedResult.merged_records``).
        """
        order = np.asarray(order, dtype=np.int64)
        if isinstance(self.tasks, TaskChunk):
            t = self.tasks
            tasks: "list[TaskInput] | TaskChunk" = TaskChunk(
                idx=t.idx[order], arrival_ms=t.arrival_ms[order],
                size=t.size[order], bytes=t.bytes[order])
        elif len(self.tasks) > 0:
            tasks = [self.tasks[int(i)] for i in order.tolist()]
        else:
            tasks = []
        opt = (lambda a: None if a is None else a[order])
        return RecordBatch(
            tasks=tasks,
            target_codes=self.target_codes[order],
            target_names=self.target_names,
            predicted_latency_ms=self.predicted_latency_ms[order],
            predicted_cost=self.predicted_cost[order],
            actual_latency_ms=self.actual_latency_ms[order],
            actual_cost=self.actual_cost[order],
            predicted_cold=self.predicted_cold[order],
            actual_cold=self.actual_cold[order],
            allowed_cost=self.allowed_cost[order],
            feasible=self.feasible[order],
            completion_ms=self.completion_ms[order],
            hedged=self.hedged[order],
            queue_wait_ms=self.queue_wait_ms[order],
            exec_ms=self.exec_ms[order],
            hedge_codes=self.hedge_codes[order],
            hedge_exec_ms=self.hedge_exec_ms[order],
            shed=self.shed[order],
            failed=self.failed[order],
            attempts=self.attempts[order],
            tier=self.tier[order],
            downgraded=self.downgraded[order],
            arrivals=opt(self.arrivals),
            task_idx=opt(self.task_idx),
            input_size=opt(self.input_size),
            input_bytes=opt(self.input_bytes),
        )


_ARENA_F64 = ("predicted_latency_ms", "predicted_cost", "actual_latency_ms",
              "actual_cost", "allowed_cost", "completion_ms", "queue_wait_ms",
              "exec_ms", "hedge_exec_ms")
_ARENA_BOOL = ("predicted_cold", "actual_cold", "feasible", "hedged",
               "shed", "failed", "downgraded")
_ARENA_I64 = ("target_codes", "hedge_codes", "attempts", "tier")


class RecordArena:
    """Growable struct-of-arrays accumulator for streaming serves.

    ``serve_stream`` appends one ``RecordBatch`` per chunk; the arena merges
    the columns in place into preallocated arrays that grow by geometric
    doubling — amortized O(1) per row, no per-chunk ``np.concatenate`` churn
    (which would copy the whole prefix on every chunk: O(n²/chunk) bytes).
    Target-name tables are unified incrementally: each chunk's codes are
    remapped through one vectorized table lookup, so batches from different
    sources (different shards, hedged fallback paths) merge cleanly.

    ``keep_tasks=False`` is the constant-memory mode: per-task objects are
    never retained — only the ``arrivals``/``task_idx`` columns — which is
    what holds a 10M-task streaming serve to O(result columns) instead of
    O(task objects). ``finish()`` returns the trimmed ``RecordBatch`` view;
    rows already appended are never rewritten, so the view stays valid if
    more rows are appended afterwards.

    ``keep_inputs=True`` additionally retains the task ``size``/``bytes``
    input-feature columns (two float64 columns — still constant-memory), so a
    streamed run that dropped its task objects can be exported back to a
    replayable trace (``repro_torch.trace.capture``) round-trip exactly.
    """

    def __init__(self, keep_tasks: bool = True, capacity: int = 0,
                 keep_inputs: bool = False):
        self.n = 0
        self.keep_tasks = keep_tasks
        self.keep_inputs = keep_inputs
        self._cap0 = max(int(capacity), 0)  # optional preallocation hint
        self._cap = 0
        self._cols: dict[str, np.ndarray] = {}
        self._names: list[str] = []
        self._code: dict[str, int] = {}
        self.tasks: list[TaskInput] = []

    def __len__(self) -> int:
        return self.n

    @property
    def nbytes(self) -> int:
        """Currently allocated column bytes (capacity, not fill)."""
        return sum(c.nbytes for c in self._cols.values())

    def _reserve(self, need: int) -> None:
        if need <= self._cap:
            return
        new_cap = max(self._cap, self._cap0, 1024)
        while new_cap < need:
            new_cap *= 2
        f64 = _ARENA_F64 + ("arrivals",)
        if self.keep_inputs:
            f64 = f64 + ("input_size", "input_bytes")
        dtypes = ({k: np.float64 for k in f64}
                  | {k: np.bool_ for k in _ARENA_BOOL}
                  | {k: np.int64 for k in _ARENA_I64 + ("task_idx",)})
        for name, dt in dtypes.items():
            fresh = np.empty(new_cap, dtype=dt)
            old = self._cols.get(name)
            if old is not None:
                fresh[:self.n] = old[:self.n]
            self._cols[name] = fresh
        self._cap = new_cap

    def _remap_table(self, names: Sequence[str]) -> np.ndarray:
        """Chunk-local code → arena code, with a trailing -1 slot so hedge
        codes of -1 pass through (``table[-1] == -1``)."""
        for nm in names:
            if nm not in self._code:
                self._code[nm] = len(self._names)
                self._names.append(nm)
        return np.array([self._code[nm] for nm in names] + [-1], dtype=np.int64)

    def append(self, records: "RecordBatch | Sequence[TaskRecord]") -> None:
        rb = RecordBatch.from_records(records)
        m = len(rb)
        if m == 0:
            return
        self._reserve(self.n + m)
        sl = slice(self.n, self.n + m)
        table = self._remap_table(rb.target_names)
        cols = self._cols
        cols["target_codes"][sl] = table[rb.target_codes]
        cols["hedge_codes"][sl] = table[rb.hedge_codes]
        cols["attempts"][sl] = rb.attempts
        cols["tier"][sl] = rb.tier
        for name in _ARENA_F64 + _ARENA_BOOL:
            cols[name][sl] = getattr(rb, name)
        cols["arrivals"][sl] = rb.arrival_ms
        if self.keep_inputs:
            size, nbytes = rb.input_arrays()  # actionable error when dropped
            cols["input_size"][sl] = size
            cols["input_bytes"][sl] = nbytes
        if rb.task_idx is not None:
            cols["task_idx"][sl] = rb.task_idx
        elif isinstance(rb.tasks, TaskChunk):
            cols["task_idx"][sl] = rb.tasks.idx
        elif len(rb.tasks) > 0:
            cols["task_idx"][sl] = [getattr(t, "idx", -1) for t in rb.tasks]
        else:
            cols["task_idx"][sl] = -1
        if self.keep_tasks:
            self.tasks.extend(rb.tasks)
        self.n += m

    def finish(self) -> RecordBatch:
        """The accumulated rows as one ``RecordBatch`` (trimmed array views)."""
        if self.n == 0:
            return RecordBatch.empty()
        c = {k: v[:self.n] for k, v in self._cols.items()}
        return RecordBatch(
            tasks=self.tasks if self.keep_tasks else [],
            target_names=tuple(self._names),
            arrivals=c.pop("arrivals"),
            task_idx=c.pop("task_idx"),
            input_size=c.pop("input_size", None),
            input_bytes=c.pop("input_bytes", None),
            **c,
        )


@dataclass(frozen=True)
class DeviceSummary:
    """Per-device load view of a fleet run (imbalance, not just aggregates)."""

    device: str
    n_tasks: int
    utilization: float        # busy occupancy / workload makespan
    queue_wait_mean_ms: float
    queue_wait_p50_ms: float
    queue_wait_p99_ms: float


@dataclass
class SimulationResult:
    """Aggregate metrics of one serve/simulation run, computed on arrays.

    ``records`` accepts either a ``RecordBatch`` (the columnar serve path) or
    a plain ``list[TaskRecord]`` (live/per-task paths, hand-built tests); the
    list form is columnarized on construction.
    """

    records: RecordBatch | list[TaskRecord] = field(default_factory=list)
    deadline_ms: float | None = None
    c_max: float | None = None
    edge_name: str = "edge"
    edge_names: tuple[str, ...] | None = None  # fleet devices (None = single)

    def __post_init__(self):
        if not isinstance(self.records, RecordBatch):
            self.records = RecordBatch.from_records(self.records)

    # ------------------------------------------------------------- totals
    @property
    def n(self) -> int:
        return len(self.records)

    @property
    def total_actual_cost(self) -> float:
        return float(np.sum(self.records.actual_cost))

    @property
    def total_predicted_cost(self) -> float:
        return float(np.sum(self.records.predicted_cost))

    @property
    def cost_error_pct(self) -> float:
        a = self.total_actual_cost
        return abs(self.total_predicted_cost - a) / max(a, 1e-12) * 100.0

    @property
    def avg_actual_latency_ms(self) -> float:
        return float(np.mean(self.records.actual_latency_ms))

    @property
    def avg_predicted_latency_ms(self) -> float:
        return float(np.mean(self.records.predicted_latency_ms))

    @property
    def latency_error_pct(self) -> float:
        a = self.avg_actual_latency_ms
        return abs(self.avg_predicted_latency_ms - a) / max(a, 1e-9) * 100.0

    @property
    def p95_actual_latency_ms(self) -> float:
        return float(np.percentile(self.records.actual_latency_ms, 95))

    @property
    def p99_actual_latency_ms(self) -> float:
        return float(np.percentile(self.records.actual_latency_ms, 99))

    # ------------------------------------------------- deadline (min-cost)
    @property
    def pct_deadline_violated(self) -> float:
        if self.deadline_ms is None:
            return 0.0
        v = int(np.count_nonzero(self.records.actual_latency_ms > self.deadline_ms))
        return v / max(self.n, 1) * 100.0

    @property
    def avg_violation_ms(self) -> float:
        if self.deadline_ms is None:
            return 0.0
        lat = self.records.actual_latency_ms
        over = lat[lat > self.deadline_ms]
        return float(np.mean(over - self.deadline_ms)) if over.size else 0.0

    # ---------------------------------------------------- budget (min-lat)
    @property
    def pct_cost_violated(self) -> float:
        allowed = self.records.allowed_cost
        v = int(np.count_nonzero(
            np.isfinite(allowed) & (self.records.actual_cost > allowed + 1e-15)))
        return v / max(self.n, 1) * 100.0

    @property
    def pct_budget_used(self) -> float:
        if self.c_max is None:
            return 0.0
        return self.total_actual_cost / max(self.c_max * self.n, 1e-12) * 100.0

    # ------------------------------------------- failure-aware serving view
    @property
    def n_shed(self) -> int:
        return int(np.count_nonzero(self.records.shed))

    @property
    def n_failed(self) -> int:
        return int(np.count_nonzero(self.records.failed))

    @property
    def pct_shed(self) -> float:
        return self.n_shed / max(self.n, 1) * 100.0

    @property
    def n_retried(self) -> int:
        """Tasks that needed more than one dispatch (retry or failover)."""
        return int(np.count_nonzero(self.records.attempts > 1))

    @property
    def n_downgraded(self) -> int:
        """Tasks demoted to a lower SLO class by fair-share reclamation."""
        return int(np.count_nonzero(self.records.downgraded))

    @property
    def pct_downgraded(self) -> float:
        return self.n_downgraded / max(self.n, 1) * 100.0

    def slo_attainment(self, deadline_ms: float,
                       tier: int | None = None) -> float:
        """Fraction of tasks (optionally of one SLO tier) that completed
        within ``deadline_ms`` of arrival. Shed and permanently-failed tasks
        count as misses — degrading by dropping work is visible here, not
        hidden by it."""
        r = self.records
        sel = np.ones(len(r), dtype=bool) if tier is None else r.tier == tier
        n_sel = int(np.count_nonzero(sel))
        if n_sel == 0:
            return 1.0
        ok = sel & ~r.shed & ~r.failed & (r.actual_latency_ms <= deadline_ms)
        return int(np.count_nonzero(ok)) / n_sel

    @property
    def n_warm_cold_mismatches(self) -> int:
        r = self.records
        edge = set(self.edge_names) if self.edge_names else {self.edge_name}
        non_edge = ~r.target_mask(edge)
        return int(np.count_nonzero(
            non_edge & (r.predicted_cold != r.actual_cold)))

    @property
    def n_edge(self) -> int:
        edge = set(self.edge_names) if self.edge_names else {self.edge_name}
        return int(np.count_nonzero(self.records.target_mask(edge)))

    def configs_used(self) -> set[str]:
        r = self.records
        return {r.target_names[c] for c in np.unique(r.target_codes).tolist()}

    # ------------------------------------------------- per-device (fleet) view
    @property
    def makespan_ms(self) -> float:
        """First arrival to last completion — the run's wall-clock horizon."""
        if not self.records:
            return 0.0
        t0 = float(np.min(self.records.arrival_ms))
        t1 = float(np.max(self.records.completion_ms))
        return max(t1 - t0, 0.0)

    def device_summaries(self) -> dict[str, DeviceSummary]:
        """Utilization and queue-wait distribution per edge device, so fleet
        benchmarks can report imbalance instead of just aggregate latency.

        Hedged duplicate dispatches count toward the device they ran on —
        both in ``n_tasks`` and in the busy time behind ``utilization`` —
        since they occupy its executor exactly like a primary dispatch.
        Queue-wait percentiles are over primary dispatches only.
        """
        devices = self.edge_names if self.edge_names else (self.edge_name,)
        span = self.makespan_ms
        r = self.records
        out: dict[str, DeviceSummary] = {}
        for dev in devices:
            code = r.code_of(dev)
            mask = r.target_codes == code if code >= 0 else np.zeros(len(r), bool)
            hmask = r.hedge_codes == code if code >= 0 else np.zeros(len(r), bool)
            waits = r.queue_wait_ms[mask] if mask.any() else np.zeros(1)
            busy = float(np.sum(r.exec_ms[mask])) + float(np.sum(r.hedge_exec_ms[hmask]))
            out[dev] = DeviceSummary(
                device=dev,
                n_tasks=int(np.count_nonzero(mask)) + int(np.count_nonzero(hmask)),
                utilization=busy / span if span > 0 else 0.0,
                queue_wait_mean_ms=float(np.mean(waits)),
                queue_wait_p50_ms=float(np.percentile(waits, 50)),
                queue_wait_p99_ms=float(np.percentile(waits, 99)),
            )
        return out

    def device_table(self) -> str:
        """Human-readable per-device summary (benchmarks and examples)."""
        rows = [f"{'device':<10} {'tasks':>6} {'util':>6} "
                f"{'wait_mean':>10} {'wait_p50':>9} {'wait_p99':>9}"]
        for s in self.device_summaries().values():
            rows.append(
                f"{s.device:<10} {s.n_tasks:>6d} {s.utilization:>6.1%} "
                f"{s.queue_wait_mean_ms:>10.0f} {s.queue_wait_p50_ms:>9.0f} "
                f"{s.queue_wait_p99_ms:>9.0f}")
        return "\n".join(rows)
