"""Workload generation (paper Sec. II-B, VI-A) — list, columnar, and streaming.

Inputs are ingested at a fixed rate from the data source; the simulator feeds
them at Poisson-process intervals (paper Sec. VI-A): 4 inputs/s for IR and FD
(traffic/smart camera), one input per 10 s for STT (smart speaker).

Three forms of the same workload:

- ``generate(n)`` — the familiar ``list[TaskInput]`` (per-task objects);
- ``TaskChunk`` — the struct-of-arrays form of a span of tasks: one float64
  column per field instead of N objects. The batched serve path
  (``predict_batch``, the columnar decision core, ``execute_many``) reads the
  columns directly, so a chunk never materializes a single ``TaskInput`` on
  the hot path — and the numpy work it feeds releases the GIL, which is what
  lets ``ShardedRuntime`` overlap independent application streams in threads;
- ``chunks(n, chunk_size)`` — a generator of ``TaskChunk``s for streaming
  serves (``PlacementRuntime.serve_stream``): O(chunk) live tasks instead of
  O(n). For ``PoissonWorkload`` the chunk stream is BIT-IDENTICAL to
  ``generate(n)`` (the gap block is drawn exactly as ``generate`` draws it,
  and per-chunk size blocks consume the Generator stream exactly like the
  per-task sampler loop — numpy Generators produce the same values drawn one
  at a time or as a block). ``BurstyWorkload.chunks`` runs the identical
  scalar phase walk and is therefore also bit-identical to its ``generate``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator, Sequence

import numpy as np


@dataclass
class TaskInput:
    idx: int
    arrival_ms: float
    size: float   # model feature: pixels (IR/FD) or bytes (STT) or tokens (LLM)
    bytes: float  # payload size for network transfer
    meta: dict = field(default_factory=dict)
    tier: int = 0  # SLO class (0 = highest) — admission control, see core.faults


@dataclass(eq=False)
class TaskChunk(Sequence):
    """Struct-of-arrays form of a span of ``TaskInput``s.

    Indexing / iterating materializes ``TaskInput`` views lazily (so every
    per-task consumer keeps working); the vectorized serve path reads the
    columns directly and never builds a view. Slicing returns a ``TaskChunk``
    over array views — what ``serve_stream`` does to walk a big chunk.
    """

    idx: np.ndarray         # (n,) int64 — position in the source workload
    arrival_ms: np.ndarray  # (n,) float64
    size: np.ndarray        # (n,) float64
    bytes: np.ndarray       # (n,) float64
    tier: np.ndarray | None = None  # (n,) int64 SLO class; None = all tier 0
    # arrival-regime ground truth (``BurstyWorkload.chunks``): True where the
    # MMPP phase walk was in its burst phase — what ``generate`` carries as
    # ``meta["burst"]``, columnar so forecaster tests have per-task truth at
    # any chunk size. None = untracked (Poisson sources, hand-built chunks).
    burst: np.ndarray | None = None  # (n,) bool

    @classmethod
    def from_tasks(cls, tasks: Sequence[TaskInput]) -> "TaskChunk":
        tiers = np.array([getattr(t, "tier", 0) for t in tasks], dtype=np.int64)
        return cls(
            idx=np.array([t.idx for t in tasks], dtype=np.int64),
            arrival_ms=np.array([t.arrival_ms for t in tasks], dtype=np.float64),
            size=np.array([t.size for t in tasks], dtype=np.float64),
            bytes=np.array([t.bytes for t in tasks], dtype=np.float64),
            tier=tiers if tiers.any() else None,
        )

    def tier_codes(self) -> np.ndarray:
        """The SLO-class column, materialized (zeros when untiered)."""
        if self.tier is not None:
            return self.tier
        return np.zeros(len(self), dtype=np.int64)

    def __len__(self) -> int:
        return self.arrival_ms.shape[0]

    def __bool__(self) -> bool:
        return len(self) > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            return TaskChunk(idx=self.idx[i], arrival_ms=self.arrival_ms[i],
                             size=self.size[i], bytes=self.bytes[i],
                             tier=None if self.tier is None else self.tier[i],
                             burst=None if self.burst is None else self.burst[i])
        i = int(i)
        return TaskInput(idx=int(self.idx[i]), arrival_ms=float(self.arrival_ms[i]),
                         size=float(self.size[i]), bytes=float(self.bytes[i]),
                         meta={"burst": bool(self.burst[i])}
                         if self.burst is not None else {},
                         tier=int(self.tier[i]) if self.tier is not None else 0)

    def __iter__(self) -> Iterator[TaskInput]:
        for i in range(len(self)):
            yield self[i]


def task_tiers(tasks) -> np.ndarray:
    """The SLO-class column of any task container (int64, 0 = highest).

    ``TaskChunk`` hands back its (possibly synthesized) tier column; task
    lists gather the per-object ``tier`` attribute. Used by the runtime's
    admission-control pass (``repro_torch.core.faults.AdmissionPolicy``).
    """
    if isinstance(tasks, TaskChunk):
        return tasks.tier_codes()
    return np.array([getattr(t, "tier", 0) for t in tasks], dtype=np.int64)


def first_disorder(arrival_ms) -> int:
    """Index of the first out-of-arrival-order element, ``-1`` if sorted.

    The serve paths treat a non-monotone arrival stream as a signal to fall
    back to the per-task walk; trace ingestion (``repro_torch.trace``) instead
    REJECTS unsorted traces up front — this is the shared detector, so the
    error can name the exact offending record.
    """
    a = np.asarray(arrival_ms, dtype=np.float64)
    if a.shape[0] < 2:
        return -1
    bad = np.nonzero(np.diff(a) < 0.0)[0]
    return int(bad[0]) + 1 if bad.size else -1


def task_arrays(tasks, fields: str = "iasb",
                ) -> tuple[np.ndarray | None, np.ndarray | None,
                           np.ndarray | None, np.ndarray | None]:
    """``(idx, arrival_ms, size, bytes)`` columns for any task container.

    ``TaskChunk`` hands its columns back for free; a ``list[TaskInput]`` is
    gathered with one comprehension per column — but only for the columns
    named in ``fields`` (``i``/``a``/``s``/``b``; the rest come back as
    ``None``), so callers that need two columns don't pay four O(n) Python
    gathers. Every vectorized stage (``predict_batch``, the columnar decision
    core, ``execute_many``) goes through here, so the object→array churn
    exists in exactly one place — and vanishes entirely on the streaming
    chunk path.
    """
    if isinstance(tasks, TaskChunk):
        return tasks.idx, tasks.arrival_ms, tasks.size, tasks.bytes
    return (
        np.array([getattr(t, "idx", -1) for t in tasks], dtype=np.int64)
        if "i" in fields else None,
        np.array([t.arrival_ms for t in tasks], dtype=np.float64)
        if "a" in fields else None,
        np.array([t.size for t in tasks], dtype=np.float64)
        if "s" in fields else None,
        np.array([t.bytes for t in tasks], dtype=np.float64)
        if "b" in fields else None,
    )


@dataclass
class PoissonWorkload:
    """Poisson arrivals with app-specific input size sampling.

    ``size_sampler_batch`` is the optional vectorized form of
    ``size_sampler``: ``(rng, n) -> (sizes, nbytes)`` arrays whose draws
    consume the Generator stream exactly like ``n`` sequential
    ``size_sampler`` calls (``AWSTwin.sample_input_batch`` satisfies this).
    With it, ``chunks()`` generates million-task streams without a Python
    loop per task.
    """

    rate_per_s: float
    size_sampler: Callable[[np.random.Generator], tuple[float, float]]
    seed: int = 0
    size_sampler_batch: Callable[[np.random.Generator, int],
                                 tuple[np.ndarray, np.ndarray]] | None = None

    def generate(self, n: int) -> list[TaskInput]:
        rng = np.random.default_rng(self.seed)
        gaps_ms = rng.exponential(1000.0 / self.rate_per_s, size=n)
        arrivals = np.cumsum(gaps_ms)
        tasks = []
        for i in range(n):
            size, nbytes = self.size_sampler(rng)
            tasks.append(TaskInput(idx=i, arrival_ms=float(arrivals[i]), size=size, bytes=nbytes))
        return tasks

    def chunks(self, n: int, chunk_size: int = 65536) -> Iterator[TaskChunk]:
        """Stream the workload as ``TaskChunk``s of ``chunk_size`` tasks.

        Bit-identical to ``generate(n)``: the full gap block is drawn first
        (exactly as ``generate`` draws it — O(n) float64s, the only O(n)
        state), then sizes are drawn in arrival order, per chunk — as one
        block when ``size_sampler_batch`` is available, else per task.
        """
        rng = np.random.default_rng(self.seed)
        arrivals = np.cumsum(rng.exponential(1000.0 / self.rate_per_s, size=n))
        for lo in range(0, n, chunk_size):
            hi = min(lo + chunk_size, n)
            m = hi - lo
            if self.size_sampler_batch is not None:
                sizes, nbytes = self.size_sampler_batch(rng, m)
                sizes = np.asarray(sizes, dtype=np.float64)
                nbytes = np.asarray(nbytes, dtype=np.float64)
            else:
                sizes = np.empty(m)
                nbytes = np.empty(m)
                for j in range(m):
                    sizes[j], nbytes[j] = self.size_sampler(rng)
            yield TaskChunk(idx=np.arange(lo, hi, dtype=np.int64),
                            arrival_ms=arrivals[lo:hi],
                            size=sizes, bytes=nbytes)


@dataclass
class BurstyWorkload:
    """Markov-modulated Poisson arrivals: quiet/burst phases (skewed arrivals).

    The process alternates between a quiet phase at ``rate_per_s`` and a burst
    phase at ``rate_per_s × burst_multiplier``; phase durations are
    exponential. Exponential gaps are memoryless, so re-drawing the gap at a
    phase switch is exact. This is the skewed-arrival scenario edge-fleet
    balancers are judged on (least-predicted-wait vs round-robin): bursts pile
    queueing onto whichever devices a backlog-blind balancer keeps feeding.
    """

    rate_per_s: float
    size_sampler: Callable[[np.random.Generator], tuple[float, float]]
    burst_multiplier: float = 8.0
    mean_quiet_s: float = 20.0
    mean_burst_s: float = 5.0
    seed: int = 0

    def _walk(self, n: int) -> Iterator[tuple[float, float, float, bool]]:
        """The scalar phase walk shared by ``generate`` and ``chunks`` —
        gap/phase/size draws interleave per task, so there is no block form."""
        rng = np.random.default_rng(self.seed)
        t = 0.0
        in_burst = False
        phase_end = rng.exponential(self.mean_quiet_s * 1e3)
        emitted = 0
        while emitted < n:
            rate = self.rate_per_s * (self.burst_multiplier if in_burst else 1.0)
            gap = rng.exponential(1000.0 / rate)
            if t + gap >= phase_end:
                t = phase_end
                in_burst = not in_burst
                mean_s = self.mean_burst_s if in_burst else self.mean_quiet_s
                phase_end = t + rng.exponential(mean_s * 1e3)
                continue
            t += gap
            size, nbytes = self.size_sampler(rng)
            yield t, size, nbytes, in_burst
            emitted += 1

    def generate(self, n: int) -> list[TaskInput]:
        return [TaskInput(idx=i, arrival_ms=t, size=size, bytes=nbytes,
                          meta={"burst": burst})
                for i, (t, size, nbytes, burst) in enumerate(self._walk(n))]

    def chunks(self, n: int, chunk_size: int = 65536) -> Iterator[TaskChunk]:
        """Stream the workload as ``TaskChunk``s — the identical scalar phase
        walk as ``generate`` (bit-identical arrivals/sizes), retaining
        O(chunk) tasks at a time. Each chunk carries the per-task regime
        flag ``generate`` puts in ``meta['burst']`` as its columnar
        ``burst`` array, so burst-forecaster tests have ground truth at any
        chunk size."""
        walk = self._walk(n)
        done = 0
        while done < n:
            m = min(chunk_size, n - done)
            arrivals = np.empty(m)
            sizes = np.empty(m)
            nbytes = np.empty(m)
            burst = np.empty(m, dtype=bool)
            for j in range(m):
                arrivals[j], sizes[j], nbytes[j], burst[j] = next(walk)
            yield TaskChunk(idx=np.arange(done, done + m, dtype=np.int64),
                            arrival_ms=arrivals, size=sizes, bytes=nbytes,
                            burst=burst)
            done += m
