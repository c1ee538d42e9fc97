"""Cross-application sharded serving: N independent app streams in parallel.

Realistic edge platforms run long-lived *mixes* of applications (EdgeBench's
IR+FD+STT trio), each with its own Predictor (its own fitted component
models), its own policy budget, and its own fleet partition. Placement state
never crosses application boundaries — an IR dispatch cannot warm an STT
container, and the paper's policies are defined per application — so the
shards are genuinely independent and can execute concurrently.

``ShardedRuntime`` runs one ``PlacementRuntime.serve_stream`` per
``AppShard``:

- **threads** (default): the streaming serve path is numpy over chunk-sized
  arrays and, on ``array_backend="torch"``, kernels on the card — both
  release the GIL, so independent shards overlap without any pickling or
  process start-up. Results are deterministic regardless of scheduling: no
  state is shared between shards.
- **processes** (``use_processes=True``): full isolation. The pool always
  starts its children with the ``spawn`` method: a child forked after its
  parent has initialised CUDA cannot use the card. Spawned children unpickle
  what they are given, so shards must carry *picklable factories*
  (module-level callables or instances of module-level classes, such as
  ``repro_torch.planner.TwinRuntimeFactory`` and
  ``repro_torch.trace.TraceChunkFactory``) rather than live objects,
  closures or functions defined in ``__main__``.
- **sequential** (``parallel=False``): the baseline.

Each shard serves inside ``repro_torch.kernels.recording``, and its kernel
launches by kernel name land in that shard's ``stream_stats["launches"]``
(all zero on the CPU, where the wrappers run their plain versions) — in
threads the tally is per thread, and children return theirs.

Shards default to ``keep_tasks=False`` (constant-memory streaming results);
per-shard ``SimulationResult``s merge into a ``ShardedResult`` cross-app
report.
"""

from __future__ import annotations

import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from repro_torch import kernels
from repro_torch.core.records import RecordArena, RecordBatch, SimulationResult
from repro_torch.core.runtime import PlacementRuntime


@dataclass
class AppShard:
    """One application stream: its runtime (or a factory) and its workload.

    ``runtime`` and ``workload`` may be live objects or zero-arg callables;
    callables are required for ``use_processes=True`` (the spawned child
    builds its own copies, so they must pickle) and are handy in threads too
    (construction then happens inside the worker, off the caller's critical
    path). A shard must own its predictor/policy/backend outright — sharing
    any of them across shards breaks both determinism and the concurrency
    story.
    """

    name: str
    runtime: "PlacementRuntime | Callable[[], PlacementRuntime]"
    workload: object  # task sequence, chunk iterator, or zero-arg factory
    chunk_size: int = 65536
    keep_tasks: bool = False

    def resolve_runtime(self) -> PlacementRuntime:
        rt = self.runtime() if callable(self.runtime) else self.runtime
        if not isinstance(rt, PlacementRuntime):
            raise TypeError(
                f"shard {self.name!r}: runtime resolved to {type(rt).__name__},"
                " expected PlacementRuntime")
        return rt

    def resolve_workload(self):
        return self.workload() if callable(self.workload) else self.workload


def _serve_shard(shard: AppShard) -> tuple[str, SimulationResult, float, dict]:
    """Top-level so process pools can pickle it; runs one shard end to end
    and adds its kernel launches to ``stream_stats["launches"]``."""
    with kernels.recording() as launches:
        rt = shard.resolve_runtime()
        t0 = time.perf_counter()
        res = rt.serve_stream(shard.resolve_workload(),
                              chunk_size=shard.chunk_size,
                              keep_tasks=shard.keep_tasks)
        wall = time.perf_counter() - t0
    stats = dict(rt.stream_stats or {})
    stats["launches"] = dict(launches)
    return shard.name, res, wall, stats


@dataclass
class ShardedResult:
    """Per-app results of one sharded serve plus the cross-app view."""

    results: dict[str, SimulationResult]
    wall_s: dict[str, float]            # per-shard serve wall time
    stream_stats: dict[str, dict]       # per-shard serve_stream aggregates
    elapsed_s: float                    # end-to-end wall time of the run
    mode: str = "thread"                # thread | process | sequential

    @property
    def n(self) -> int:
        return sum(r.n for r in self.results.values())

    @property
    def total_actual_cost(self) -> float:
        return sum(r.total_actual_cost for r in self.results.values())

    def merged_records(self) -> tuple[RecordBatch, np.ndarray, tuple[str, ...]]:
        """All shards' rows as ONE batch in global arrival order.

        Returns ``(batch, app_codes, app_names)``: the per-shard record
        batches merged through a ``RecordArena`` (target tables unified) and
        stable-sorted by arrival time — ties keep shard declaration order, so
        the merge is deterministic. ``app_codes[i]`` indexes ``app_names``
        (the shard names) for row ``i``. This is the cross-application view a
        recorded multi-app day looks like on the wire, and the natural input
        for capturing a sharded run back into one multi-app trace
        (``repro_torch.trace.capture_sharded`` captures per shard and merges
        the traces the same way).
        """
        arena = RecordArena(keep_tasks=False)
        codes: list[np.ndarray] = []
        names = tuple(self.results)
        for k, res in enumerate(self.results.values()):
            arena.append(res.records)
            codes.append(np.full(len(res.records), k, dtype=np.int64))
        rb = arena.finish()
        code = np.concatenate(codes) if codes else np.zeros(0, np.int64)
        order = np.argsort(rb.arrival_ms, kind="stable") if len(rb) \
            else np.zeros(0, np.int64)
        return rb.take(order), code[order], names

    def table(self) -> str:
        """Human-readable cross-application report."""
        rows = [f"{'app':<8} {'tasks':>9} {'mean ms':>9} {'p99 ms':>10} "
                f"{'edge#':>9} {'cost $':>11} {'wall s':>7}"]
        for name, r in self.results.items():
            rows.append(
                f"{name:<8} {r.n:>9,d} {r.avg_actual_latency_ms:>9.0f} "
                f"{r.p99_actual_latency_ms:>10.0f} {r.n_edge:>9,d} "
                f"{r.total_actual_cost:>11.5f} {self.wall_s[name]:>7.2f}")
        rows.append(
            f"{'TOTAL':<8} {self.n:>9,d} {'':>9} {'':>10} {'':>9} "
            f"{self.total_actual_cost:>11.5f} {self.elapsed_s:>7.2f}")
        return "\n".join(rows)


class ShardedRuntime:
    """N application shards served as one cross-application run."""

    def __init__(self, shards: Sequence[AppShard],
                 max_workers: int | None = None):
        names = [s.name for s in shards]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate shard names: {names}")
        if not shards:
            raise ValueError("at least one shard is required")
        self.shards = list(shards)
        self.max_workers = max_workers

    def serve(self, parallel: bool = True,
              use_processes: bool = False) -> ShardedResult:
        """Serve every shard; merge per-shard results into a cross-app report.

        Per-shard results are identical across all three modes — shards share
        no state, so scheduling cannot perturb a single draw or decision.
        """
        t0 = time.perf_counter()
        if not parallel:
            outs = [_serve_shard(s) for s in self.shards]
            mode = "sequential"
        else:
            workers = self.max_workers or len(self.shards)
            if use_processes:
                for s in self.shards:
                    if not (callable(s.runtime) and callable(s.workload)):
                        raise ValueError(
                            f"shard {s.name!r}: use_processes=True requires "
                            "runtime and workload factories (callables) so "
                            "the child process builds its own copies")
                pool = ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("spawn"))
                mode = "process"
            else:
                pool = ThreadPoolExecutor(max_workers=workers)
                mode = "thread"
            with pool:
                outs = list(pool.map(_serve_shard, self.shards))
        elapsed = time.perf_counter() - t0
        return ShardedResult(
            results={name: res for name, res, _, _ in outs},
            wall_s={name: wall for name, _, wall, _ in outs},
            stream_stats={name: st for name, _, _, st in outs},
            elapsed_s=elapsed,
            mode=mode,
        )


def serve_sharded(shards: Sequence[AppShard], parallel: bool = True,
                  use_processes: bool = False,
                  max_workers: int | None = None) -> ShardedResult:
    """Convenience wrapper: ``ShardedRuntime(shards).serve(...)``."""
    return ShardedRuntime(shards, max_workers=max_workers).serve(
        parallel=parallel, use_processes=use_processes)
