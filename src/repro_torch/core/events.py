"""The event scheduler behind the event-driven serving runtime.

``PlacementRuntime.serve_async`` and the backends' concurrent runners share
one discrete-event core: a min-heap of (arrival | dispatch | completion)
events on the *virtual* arrival clock. The heap's ordering contract is what
makes the async serve path deterministic — and therefore testable against the
batched columnar serve:

- events pop in nondecreasing ``time_ms``;
- at equal times, **completions pop before dispatches, dispatches before
  arrivals** (``COMPLETION < DISPATCH < ARRIVAL``). A slot freed at ``t`` is
  visible to a task arriving at ``t`` — exactly the ``start = max(free, now)``
  convention of the FIFO recurrences (``repro_torch.core.recurrence.fifo_starts``),
  so a task never waits on a completion that happens "at the same instant";
- within the same ``(time_ms, kind)``, events pop in push (FIFO) order — the
  ``seq`` counter breaks every remaining tie, so heap order is total and no
  comparison ever falls through to payload objects.

``SingleSlotWorker`` is the one-executor state machine the virtual-clock
runners build per edge device: tasks enter a FIFO queue on arrival, occupy
the slot for their compute time, and free it at ``start + busy`` — the
event-driven form of the same recurrence ``fifo_starts`` evaluates as segment
cumsums. Both express ``start_j = max(free, now_j); free = start_j + busy_j``,
which is what lets ``TwinBackend.execute_async`` stay bit-identical to the
batched ``execute_many`` while genuinely interleaving per-target workers on
the heap.
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterator

# Tie priority at equal virtual times: a completion frees capacity that a
# simultaneous dispatch/arrival is allowed to use (never the reverse).
# Preemptions (fair-share reclamation revising placements) order after
# arrivals: a victim is only re-placed once everything arriving at the same
# instant has been seen, so the reclaim schedule is a pure function of the
# arrival prefix.
COMPLETION = 0
DISPATCH = 1
ARRIVAL = 2
PREEMPT = 3

KIND_NAMES = {COMPLETION: "completion", DISPATCH: "dispatch",
              ARRIVAL: "arrival", PREEMPT: "preempt"}


@dataclass(frozen=True)
class Event:
    """One scheduled event: ``(time_ms, kind, seq)`` is its total order."""

    time_ms: float
    kind: int          # COMPLETION | DISPATCH | ARRIVAL
    seq: int           # push order — the final, always-distinct tie-break
    payload: Any = None

    @property
    def key(self) -> tuple[float, int, int]:
        return (self.time_ms, self.kind, self.seq)


class EventHeap:
    """Min-heap of ``Event``s with the deterministic ordering contract above."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, int, Event]] = []
        self._seq = 0

    def push(self, time_ms: float, kind: int, payload: Any = None) -> Event:
        if kind not in KIND_NAMES:
            raise ValueError(f"unknown event kind {kind!r}")
        ev = Event(time_ms=float(time_ms), kind=kind, seq=self._seq,
                   payload=payload)
        self._seq += 1
        heapq.heappush(self._heap, (ev.time_ms, ev.kind, ev.seq, ev))
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[3]

    def peek(self) -> Event:
        return self._heap[0][3]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        """Pop until empty. Events pushed while draining are drained too."""
        while self._heap:
            yield self.pop()


@dataclass
class SingleSlotWorker:
    """One single-slot FIFO executor driven by heap events.

    The virtual-clock equivalent of one edge device: ``arrive`` queues a task
    (and starts it if the slot is free), ``complete`` frees the slot and
    starts the next queued task. Start times follow ``start = max(free, now)``
    — bit-identical to ``repro_torch.core.recurrence.fifo_starts`` over the same
    (arrival, busy) sequence, which the parity tests assert.
    """

    free_at: float = 0.0
    queue: deque = field(default_factory=deque)
    in_flight: Any = None

    def arrive(self, now: float, item: Any) -> tuple[float, Any] | None:
        """A task arrives. Returns ``(start_ms, item)`` if it starts now
        (i.e. the slot is free), else ``None`` (queued behind the backlog)."""
        if self.in_flight is None:
            self.in_flight = item
            return (max(self.free_at, now), item)
        self.queue.append(item)
        return None

    def complete(self, free_ms: float) -> tuple[float, Any] | None:
        """The running task frees the slot at ``free_ms``. Returns
        ``(start_ms, item)`` for the next queued task, if any."""
        self.free_at = free_ms
        self.in_flight = None
        if self.queue:
            item = self.queue.popleft()
            self.in_flight = item
            return (free_ms, item)
        return None
