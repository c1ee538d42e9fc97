"""Spans of the port's serving path and set-up: named intervals on the
host's ``time.perf_counter_ns`` clock, kept in memory.

Recording is off by default. A boundary then reads the module's ``_on``
flag and stops there: no clock read, no lock, nothing kept. ``enable()``
drops what was kept, reads the clock anchor and starts recording;
``drain()`` returns the spans kept since, in start order, with the anchor;
``disable()`` stops recording.

    with spans.span("exec", seed=7) as sp:
        ...
        sp.set(cold=True)

A span holds its name, its start and end (``perf_counter_ns``), the native
id of its thread (``threading.get_native_id``, the ``tid`` that
``torch.profiler`` gives that thread's host events), its own id, its
parent's id and its attributes. The parent is the innermost span open on
the same thread, or the one passed as ``parent=``: a worker thread's span
hangs under the span that started the worker that way (``current()`` gives
the id to pass). Each thread appends to a list of its own; ``drain`` merges
them.

The anchor is one (``time.time_ns()``, ``time.perf_counter_ns()``) pair
read together at ``enable``. ``Anchor.wall_ns`` puts a span's times on the
Unix epoch, where a ``torch.profiler`` chrome trace counts from: an event's
``ts`` (us) plus its ``baseTimeNanoseconds`` / 1000 is its Unix time in us.

Spans add no counters: the pool's ``cap_waits``, ``cap_wait_ms``,
``reclaimed`` and ``peak_resident``, the graphs' replayed launches and the
runtime's ``stream_stats`` stay where they are.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass

_on = False
_gen = 0          # bumped by ``enable`` and ``drain``: threads take new lists
_lock = threading.Lock()
_lists: list[list["Span"]] = []
_ids = itertools.count(1)
_anchor: "Anchor | None" = None
_tl = threading.local()


@dataclass(frozen=True)
class Anchor:
    """One reading of the Unix clock and of ``perf_counter_ns`` together."""

    unix_ns: int
    perf_ns: int

    def wall_ns(self, perf_ns: int) -> int:
        """``perf_ns`` (a span's clock) on the Unix epoch, in ns."""
        return self.unix_ns + (perf_ns - self.perf_ns)


def _local():
    """This thread's stack of open span ids and its list of closed spans
    (registered for ``drain`` once per generation)."""
    tl = _tl
    if getattr(tl, "gen", -1) != _gen:
        with _lock:
            tl.gen = _gen
            tl.spans = []
            _lists.append(tl.spans)
        if not hasattr(tl, "stack"):
            tl.stack = []
            tl.tid = threading.get_native_id()
            tl.ident = threading.get_ident()
    return tl


class Span:
    """One recorded interval; a context manager that closes it."""

    __slots__ = ("name", "start_ns", "end_ns", "tid", "ident", "id", "parent",
                 "attrs", "_stack")

    def __init__(self, name: str, parent: int | None, attrs: dict):
        self.name = name
        self.parent = parent
        self.attrs = attrs
        self.id = next(_ids)
        self.start_ns = self.end_ns = 0

    def set(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tl = _local()
        self.tid = tl.tid
        self.ident = tl.ident
        self._stack = tl.stack
        if self.parent is None:
            self.parent = tl.stack[-1] if tl.stack else 0
        tl.stack.append(self.id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        self._stack.pop()
        _local().spans.append(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"tid={self.tid}, {self.end_ns - self.start_ns} ns, "
                f"{self.attrs})")


class _Off:
    """What ``span`` returns while recording is off."""

    __slots__ = ()
    id = 0

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, parent: int | None = None, **attrs):
    """A span named ``name`` for a ``with`` block, under ``parent`` (an id
    from ``current()``) or else the innermost span open on this thread."""
    if not _on:
        return _OFF
    return Span(name, parent, attrs)


def current() -> int:
    """The id of the innermost span open on this thread; 0 when there is
    none or recording is off."""
    if not _on:
        return 0
    stack = _local().stack
    return stack[-1] if stack else 0


def enabled() -> bool:
    return _on


def enable() -> Anchor:
    """Drop every span kept so far, read the anchor and start recording."""
    global _on, _gen, _anchor
    with _lock:
        _gen += 1
        _lists.clear()
        _anchor = Anchor(time.time_ns(), time.perf_counter_ns())
        _on = True
        return _anchor


def disable() -> None:
    global _on
    _on = False


def drain() -> tuple[list[Span], Anchor | None]:
    """The spans closed since ``enable`` or the last ``drain``, in start
    order, and the anchor of the last ``enable`` (None if never enabled)."""
    global _gen
    with _lock:
        _gen += 1
        out = [s for lst in _lists for s in lst]
        _lists.clear()
        anchor = _anchor
    out.sort(key=lambda s: (s.start_ns, s.id))
    return out, anchor
