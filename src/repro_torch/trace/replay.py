"""Replaying traces through the serve paths, and capturing runs back out.

``TraceWorkload`` is the replay side: it wears the same ``generate`` /
``chunks`` interface as ``PoissonWorkload``/``BurstyWorkload``, but instead of
drawing arrivals it slices the trace's own float64 columns into ``TaskChunk``
views. No value is recomputed, re-parsed, or re-sampled on the way in — the
chunks ARE the trace arrays — so replaying a trace through ``serve_stream`` is
bit-identical to serving the equivalent in-memory task list, at every chunk
size (the existing streaming-parity guarantee does the rest: all sequential
state lives outside the chunk).

``capture`` is the inverse: any served ``SimulationResult`` (or raw
``RecordBatch``) back out as a ``Trace``, observed latencies included. A
captured trace replays to the same records, and capture∘replay is exact —
the round trip the planner's what-if search rests on. ``capture_sharded`` /
``trace_shards`` extend both directions across multi-app runs: a multi-app
trace splits per app (deterministic, order-preserving) into ``AppShard``s for
``ShardedRuntime``, and a sharded run merges back into one multi-app trace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Mapping

import numpy as np

from repro_torch.core.faults import FaultSpec
from repro_torch.core.multiapp import AppShard, ShardedResult
from repro_torch.core.records import RecordBatch, SimulationResult
from repro_torch.core.runtime import PlacementRuntime
from repro_torch.core.workload import TaskChunk, TaskInput
from repro_torch.trace.format import Trace, TraceError, merge


@dataclass(eq=False)
class TraceWorkload:
    """A recorded trace wearing the workload interface (replay source).

    ``chunks()`` yields ``TaskChunk`` *views* over the trace's columns —
    zero-copy, and trivially bit-identical to ``generate()``'s task list, so
    every parity property the synthetic workloads enjoy transfers to replay.
    Multi-app traces replay fine through a single runtime (one app's models
    serve all records); use ``trace_shards`` to route each app to its own
    runtime instead.
    """

    trace: Trace

    @property
    def n(self) -> int:
        return self.trace.n

    def __len__(self) -> int:
        return self.trace.n

    def _clip(self, n: int | None) -> int:
        if n is None:
            return self.trace.n
        if n > self.trace.n:
            raise TraceError(
                f"replay of {n} tasks requested but the trace has only "
                f"{self.trace.n} records")
        return max(int(n), 0)

    def generate(self, n: int | None = None) -> list[TaskInput]:
        """The first ``n`` trace records as per-task objects (parity tests,
        per-task consumers); defaults to the whole trace."""
        n = self._clip(n)
        t = self.trace
        return [TaskInput(idx=i, arrival_ms=float(t.arrival_ms[i]),
                          size=float(t.size[i]), bytes=float(t.bytes[i]))
                for i in range(n)]

    def chunks(self, n: int | None = None,
               chunk_size: int = 65536) -> Iterator[TaskChunk]:
        """Stream the first ``n`` records (default: all) as ``TaskChunk``
        views of the trace columns — the constant-overhead replay path."""
        n = self._clip(n)
        t = self.trace
        for lo in range(0, n, chunk_size):
            hi = min(lo + chunk_size, n)
            yield TaskChunk(idx=np.arange(lo, hi, dtype=np.int64),
                            arrival_ms=t.arrival_ms[lo:hi],
                            size=t.size[lo:hi], bytes=t.bytes[lo:hi])

    def task_chunk(self) -> TaskChunk:
        """The whole trace as one columnar chunk (``serve_stream`` slices it)."""
        return self.trace.task_chunk()


def capture(result: "SimulationResult | RecordBatch", app: str = "app",
            observed: bool = True, meta: dict | None = None,
            faults: "FaultSpec | None" = None) -> Trace:
    """A served run back out as a single-app ``Trace``.

    Reads the record batch's arrival and input-feature columns — present when
    the run kept its tasks (``serve``, ``serve_stream(keep_tasks=True)``) or
    retained the input columns (``serve_stream(keep_inputs=True)``, the
    constant-memory spelling); otherwise ``input_arrays`` raises an actionable
    error naming both fixes. ``observed=True`` stores the run's actual
    latencies as ``observed_latency_ms``, so a replay can be compared against
    what the captured run saw.

    ``faults`` embeds the run's ``FaultSpec`` in the trace meta (under
    ``"fault_spec"``), so a chaos run is replayable with its exact fault
    schedule: ``fault_spec_of(trace)`` reconstructs the spec on the way back
    in, and the counter-based fault streams make the schedule a pure function
    of (spec, dispatch times) — identical on replay.
    """
    rb = result.records if isinstance(result, SimulationResult) else result
    size, nbytes = rb.input_arrays()
    if faults is not None:
        meta = dict(meta or {})
        meta["fault_spec"] = faults.to_json()
    return Trace.from_arrays(
        np.array(rb.arrival_ms, dtype=np.float64, copy=True),
        np.array(size, dtype=np.float64, copy=True),
        np.array(nbytes, dtype=np.float64, copy=True),
        app_names=(app,),
        observed_latency_ms=np.array(rb.actual_latency_ms, copy=True)
        if observed else None,
        meta=meta,
    )


def fault_spec_of(trace: Trace) -> "FaultSpec | None":
    """The ``FaultSpec`` a chaos capture embedded in ``trace.meta``, or
    ``None`` for traces captured without one. The inverse of
    ``capture(..., faults=spec)`` — survives the JSONL/NPZ round trip."""
    payload = (trace.meta or {}).get("fault_spec")
    if payload is None:
        return None
    return FaultSpec.from_json(payload)


def capture_sharded(sharded: ShardedResult, observed: bool = True) -> Trace:
    """A multi-app sharded run as ONE multi-app trace.

    Captures each shard's result as a single-app trace and interleaves them by
    arrival time (``format.merge`` — stable, shard order breaks ties), the
    same global order ``ShardedResult.merged_records`` reports.
    """
    return merge({name: capture(res, app=name, observed=observed)
                  for name, res in sharded.results.items()})


@dataclass(eq=False)
class TraceChunkFactory:
    """Picklable zero-arg workload factory over a (single-app) trace.

    ``ShardedRuntime(use_processes=True)`` requires shard workloads to be
    factories so children build their own copies; a ``Trace`` is plain
    ndarrays and pickles cheaply, so this is all a process-mode replay needs.
    """

    trace: Trace

    def __call__(self) -> TaskChunk:
        return self.trace.task_chunk()


def trace_shards(trace: Trace,
                 runtimes: Mapping[str, "PlacementRuntime | Callable[[], PlacementRuntime]"],
                 chunk_size: int = 65536, keep_tasks: bool = False,
                 as_factories: bool = False) -> list[AppShard]:
    """Split a multi-app trace into per-app ``AppShard``s for sharded replay.

    The split is ``Trace.split_by_app`` — deterministic and order-preserving,
    so each shard's stream is exactly the trace filtered to that app up front
    (the regression tests pin this equivalence). ``runtimes`` maps every app
    name in the trace to its runtime or runtime factory; ``as_factories=True``
    wraps each sub-trace in a picklable ``TraceChunkFactory`` (required for
    ``use_processes=True``, where runtimes must be factories too).
    """
    missing = [a for a in trace.app_names if a not in runtimes]
    if missing:
        raise TraceError(
            f"no runtime supplied for trace apps {missing}; this trace's "
            f"apps are {list(trace.app_names)}")
    shards = []
    for app, sub in trace.split_by_app().items():
        workload = TraceChunkFactory(sub) if as_factories else sub.task_chunk()
        shards.append(AppShard(name=app, runtime=runtimes[app],
                               workload=workload, chunk_size=chunk_size,
                               keep_tasks=keep_tasks))
    return shards
