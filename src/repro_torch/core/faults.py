"""Deterministic fault injection for the twin, plus failure-policy config.

``FaultSpec`` is a declarative, seeded description of what goes wrong in a
run: per-target crash/outage windows, per-cloud-config transient dispatch
errors with probability ``p``, cold-start multiplier spikes, straggler
slowdown windows, and network-leg blackouts. ``TwinBackend`` consults it on
every dispatch — but NEVER through the ground-truth RNG streams:

- window faults (outages, spikes, stragglers, blackouts) are pure functions
  of the dispatch time, so they are deterministic and identical no matter
  which serve path replays them;
- probabilistic faults (transient errors) draw from a dedicated COUNTER-BASED
  stream: a splitmix64-style hash of ``(fault seed, target, task idx,
  dispatch-time bits)`` mapped to [0, 1). The draw is stateless, so it is
  order-independent — the batched, streaming, and event-driven paths see the
  identical fault schedule by construction — and it can never perturb the
  per-(substrate, leg) ground-truth streams. An empty spec takes exactly the
  existing code path: bit-identical output, zero extra draws.

The module also carries the failure-policy configuration the runtime consumes
(``RetryPolicy``, ``CircuitBreaker``/``TargetHealth``, ``SLOTier``/
``AdmissionPolicy``) so every knob of the failure-aware serve loop lives in
one importable place. Validation raises ``FaultError`` with the offending
entry indexed and named, in the style of ``repro_torch.trace.TraceError``.
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass, fields

import numpy as np

# failure kinds, as they appear in ``ExecutionOutcome.fail_kind`` /
# ``ExecutionBatch.fail_kind`` (0 = the dispatch succeeded)
OK = 0
TRANSIENT = 1   # dispatch error mid-flight: legs ran, result lost, retryable
OUTAGE = 2      # target down at dispatch time: fail-fast, nothing ran
BLACKOUT = 3    # network leg dark: upload fails fast / result upload lost
BREAKER = 4     # circuit open: the runtime failed fast without dispatching

FAIL_NAMES = {OK: "ok", TRANSIENT: "transient", OUTAGE: "outage",
              BLACKOUT: "blackout", BREAKER: "breaker"}

BLACKOUT_LEGS = ("upld", "iot")


class FaultError(ValueError):
    """An invalid ``FaultSpec`` / failure-policy configuration, with the
    offending entry indexed (the ``TraceError`` convention)."""


# ------------------------------------------------------- counter-based stream
_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (wrapping uint64 arithmetic — the overflow IS
    the hash, so the numpy overflow warning is suppressed)."""
    with np.errstate(over="ignore"):
        z = (z + _GOLDEN) & _MASK
        z = ((z ^ (z >> np.uint64(30))) * _MIX1) & _MASK
        z = ((z ^ (z >> np.uint64(27))) * _MIX2) & _MASK
    return z ^ (z >> np.uint64(31))


def fault_uniform(seed: int, target: str, idx, t_ms) -> np.ndarray:
    """Stateless uniform [0, 1) draw for fault decisions.

    Keyed by ``(seed, crc32(target), task idx, float64 bits of the dispatch
    time)`` — the same per-target keying as the ground-truth streams
    (``edge_stream_key``), but through a counter-based hash instead of a
    sequential Generator, so the value depends only on the key, never on how
    many draws happened before it. A retry of the same task on the same
    target redraws because its dispatch time moved (backoff > 0).
    Vectorized: ``idx``/``t_ms`` may be arrays (broadcast together).
    """
    idx = np.asarray(idx, dtype=np.int64).astype(np.uint64)
    bits = np.asarray(t_ms, dtype=np.float64).view(np.uint64)
    key = np.uint64((seed ^ zlib.crc32(target.encode("utf-8"))) & 0xFFFFFFFF)
    z = _mix64(_mix64(_mix64(key) ^ idx) ^ bits)
    return (z >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


# ------------------------------------------------------------- fault entries
@dataclass(frozen=True)
class OutageWindow:
    """``target`` is hard-down for dispatches in ``[start_ms, end_ms)``:
    they fail fast (nothing runs, no draws consumed, no queue occupancy)."""

    target: str
    start_ms: float
    end_ms: float


@dataclass(frozen=True)
class TransientErrors:
    """Dispatches to ``target`` fail mid-flight with probability ``p``: every
    attempted leg runs (and bills), the result is lost. Retryable."""

    target: str
    p: float


@dataclass(frozen=True)
class ColdSpike:
    """Cold starts of cloud config ``target`` triggered inside the window are
    ``factor``× slower (a deploy storm / image-pull stampede)."""

    target: str
    start_ms: float
    end_ms: float
    factor: float


@dataclass(frozen=True)
class Straggler:
    """Compute on ``target`` dispatched inside the window runs ``factor``×
    slower (thermal throttling, noisy neighbor)."""

    target: str
    start_ms: float
    end_ms: float
    factor: float


@dataclass(frozen=True)
class Blackout:
    """Network leg ``leg`` is dark in the window: ``"upld"`` fails a cloud
    dispatch fast (payload never leaves), ``"iot"`` loses an edge result
    after compute ran (the executor was still occupied). ``target=None``
    applies to every target using that leg."""

    leg: str
    start_ms: float
    end_ms: float
    target: str | None = None


def _check_window(kind: str, i: int, start_ms: float, end_ms: float) -> None:
    if not np.isfinite(start_ms) or start_ms < 0.0:
        raise FaultError(
            f"{kind}[{i}]: negative or non-finite start_ms {start_ms!r} — "
            f"windows are on the arrival clock, which starts at 0")
    if not end_ms > start_ms:
        raise FaultError(
            f"{kind}[{i}]: empty window — end_ms {end_ms!r} must be > "
            f"start_ms {start_ms!r}")


def _windows_by_target(kind: str, entries) -> dict[str | None, np.ndarray]:
    """Group window entries per target as sorted ``(k, 2)`` float arrays,
    rejecting overlaps within a target (the offending entry indexed)."""
    order: dict[str | None, list[tuple[float, float, int]]] = {}
    for i, w in enumerate(entries):
        _check_window(kind, i, w.start_ms, w.end_ms)
        order.setdefault(w.target, []).append((w.start_ms, w.end_ms, i))
    out: dict[str | None, np.ndarray] = {}
    for tgt, ws in order.items():
        ws.sort()
        for (s0, e0, i0), (s1, _e1, i1) in zip(ws, ws[1:]):
            if s1 < e0:
                raise FaultError(
                    f"{kind}[{i1}]: window [{s1}, ...) for target {tgt!r} "
                    f"overlaps {kind}[{i0}] [{s0}, {e0}) — merge them or "
                    f"make the windows disjoint")
        out[tgt] = np.array([(s, e) for s, e, _ in ws], dtype=np.float64)
    return out


def _in_windows(windows: np.ndarray | None, t_ms) -> np.ndarray:
    """Boolean mask: which times fall inside any ``[start, end)`` window."""
    t = np.asarray(t_ms, dtype=np.float64)
    hit = np.zeros(t.shape, dtype=bool)
    if windows is not None:
        for s, e in windows:
            hit |= (t >= s) & (t < e)
    return hit


@dataclass(frozen=True)
class FaultSpec:
    """The declarative fault schedule for one run. Immutable, validated at
    construction, JSON round-trippable (``to_json``/``from_json``) so a
    fault schedule can be captured alongside a trace and replayed.

    ``seed`` keys the dedicated transient-error hash stream (never the
    ground-truth streams). ``detect_ms`` is the failure-detection latency
    charged to a fail-fast dispatch (outage / upld blackout / lost result).
    """

    seed: int = 0
    outages: tuple[OutageWindow, ...] = ()
    transient: tuple[TransientErrors, ...] = ()
    cold_spikes: tuple[ColdSpike, ...] = ()
    stragglers: tuple[Straggler, ...] = ()
    blackouts: tuple[Blackout, ...] = ()
    detect_ms: float = 5.0

    def __post_init__(self):
        object.__setattr__(self, "outages", tuple(self.outages))
        object.__setattr__(self, "transient", tuple(self.transient))
        object.__setattr__(self, "cold_spikes", tuple(self.cold_spikes))
        object.__setattr__(self, "stragglers", tuple(self.stragglers))
        object.__setattr__(self, "blackouts", tuple(self.blackouts))
        if not np.isfinite(self.detect_ms) or self.detect_ms < 0.0:
            raise FaultError(
                f"detect_ms must be a finite non-negative duration, got "
                f"{self.detect_ms!r}")
        for i, t in enumerate(self.transient):
            if not 0.0 <= t.p <= 1.0:
                raise FaultError(
                    f"transient[{i}]: probability p must be in [0, 1], got "
                    f"{t.p!r} for target {t.target!r}")
        for kind, entries in (("cold_spikes", self.cold_spikes),
                              ("stragglers", self.stragglers)):
            for i, s in enumerate(entries):
                if not np.isfinite(s.factor) or s.factor <= 0.0:
                    raise FaultError(
                        f"{kind}[{i}]: factor must be a positive finite "
                        f"multiplier, got {s.factor!r} for target "
                        f"{s.target!r}")
        for i, b in enumerate(self.blackouts):
            if b.leg not in BLACKOUT_LEGS:
                raise FaultError(
                    f"blackouts[{i}]: unknown network leg {b.leg!r} — "
                    f"expected one of {BLACKOUT_LEGS}")
        # grouped window tables (validated: overlaps rejected with the index)
        object.__setattr__(self, "_outage_w",
                           _windows_by_target("outages", self.outages))
        object.__setattr__(self, "_spike_w",
                           _windows_by_target("cold_spikes", self.cold_spikes))
        object.__setattr__(self, "_strag_w",
                           _windows_by_target("stragglers", self.stragglers))
        bo: dict[str, list[Blackout]] = {}
        for b in self.blackouts:
            bo.setdefault(b.leg, []).append(b)
        object.__setattr__(self, "_blackout_w", {
            leg: _windows_by_target(f"blackouts[leg={leg!r}]", entries)
            for leg, entries in bo.items()})
        object.__setattr__(self, "_transient_p",
                           {t.target: float(t.p) for t in self.transient
                            if t.p > 0.0})

    # ------------------------------------------------------------- queries
    def __bool__(self) -> bool:
        return bool(self.outages or self._transient_p or self.cold_spikes
                    or self.stragglers or self.blackouts)

    def outage_mask(self, target: str, t_ms) -> np.ndarray:
        return _in_windows(self._outage_w.get(target), t_ms)

    def blackout_mask(self, leg: str, target: str, t_ms) -> np.ndarray:
        w = self._blackout_w.get(leg, {})
        return _in_windows(w.get(target), t_ms) | _in_windows(w.get(None), t_ms)

    def transient_p(self, target: str) -> float:
        return self._transient_p.get(target, 0.0)

    def transient_mask(self, target: str, idx, t_ms) -> np.ndarray:
        """Which dispatches of ``target`` fail transiently — the dedicated
        counter-based stream, so the answer is path-independent."""
        p = self.transient_p(target)
        t = np.asarray(t_ms, dtype=np.float64)
        if p <= 0.0:
            return np.zeros(t.shape, dtype=bool)
        return fault_uniform(self.seed, target, idx, t) < p

    def _factor(self, table, target: str, t_ms, entries, attr) -> np.ndarray:
        t = np.asarray(t_ms, dtype=np.float64)
        out = np.ones(t.shape, dtype=np.float64)
        if table.get(target) is not None:
            for e in entries:
                if e.target == target:
                    out = np.where((t >= e.start_ms) & (t < e.end_ms),
                                   out * getattr(e, attr), out)
        return out

    def cold_factor(self, target: str, trigger_ms) -> np.ndarray:
        """Cold-start multiplier per trigger time (1.0 outside spikes)."""
        return self._factor(self._spike_w, target, trigger_ms,
                            self.cold_spikes, "factor")

    def straggler_factor(self, target: str, t_ms) -> np.ndarray:
        """Compute multiplier per dispatch time (1.0 outside windows)."""
        return self._factor(self._strag_w, target, t_ms,
                            self.stragglers, "factor")

    # --------------------------------------------------------------- (de)ser
    def to_json(self) -> str:
        def row(e):
            return {f.name: getattr(e, f.name) for f in fields(e)}
        return json.dumps({
            "version": 1, "seed": self.seed, "detect_ms": self.detect_ms,
            "outages": [row(e) for e in self.outages],
            "transient": [row(e) for e in self.transient],
            "cold_spikes": [row(e) for e in self.cold_spikes],
            "stragglers": [row(e) for e in self.stragglers],
            "blackouts": [row(e) for e in self.blackouts],
        })

    @classmethod
    def from_json(cls, payload: str) -> "FaultSpec":
        d = json.loads(payload)
        v = d.get("version", 1)
        if v != 1:
            raise FaultError(
                f"unsupported fault-spec version {v!r} (this build reads "
                f"version 1) — re-export the spec or upgrade")
        return cls(
            seed=int(d.get("seed", 0)),
            detect_ms=float(d.get("detect_ms", 5.0)),
            outages=tuple(OutageWindow(**e) for e in d.get("outages", [])),
            transient=tuple(TransientErrors(**e) for e in d.get("transient", [])),
            cold_spikes=tuple(ColdSpike(**e) for e in d.get("cold_spikes", [])),
            stragglers=tuple(Straggler(**e) for e in d.get("stragglers", [])),
            blackouts=tuple(Blackout(**e) for e in d.get("blackouts", [])),
        )


# --------------------------------------------------------- failure policies
@dataclass(frozen=True)
class RetryPolicy:
    """How the runtime reacts to failed dispatches.

    A transient failure retries the SAME target after exponential backoff
    (``backoff_ms * backoff_mult**(retry-1)``); an outage/blackout/breaker
    failure (or exhausted same-target retries) fails over to the next-best
    surviving target immediately. ``max_attempts`` bounds total dispatches
    per task (first attempt included); ``timeout_ms`` gives up once the
    failure-detection time exceeds ``arrival + timeout_ms``. The default
    ``timeout_ms=inf`` means a retry-configured runtime over an empty
    ``FaultSpec`` never changes behavior: nothing fails, nothing fires.
    """

    max_attempts: int = 3
    backoff_ms: float = 50.0
    backoff_mult: float = 2.0
    timeout_ms: float = float("inf")
    failover: bool = True

    def __post_init__(self):
        if self.max_attempts < 1:
            raise FaultError(
                f"max_attempts must be >= 1 (the first dispatch counts), "
                f"got {self.max_attempts!r}")
        if not self.backoff_ms >= 0.0 or not np.isfinite(self.backoff_ms):
            raise FaultError(
                f"backoff_ms must be a finite non-negative duration, got "
                f"{self.backoff_ms!r}")
        if not self.backoff_mult >= 1.0 or not np.isfinite(self.backoff_mult):
            raise FaultError(
                f"backoff_mult must be finite and >= 1 (non-shrinking "
                f"backoff), got {self.backoff_mult!r}")
        if not self.timeout_ms > 0.0:
            raise FaultError(
                f"timeout_ms must be a positive duration (inf = no "
                f"timeout), got {self.timeout_ms!r}")

    def backoff_for(self, retry: int) -> float:
        """Backoff before same-target retry number ``retry`` (1-based)."""
        return self.backoff_ms * self.backoff_mult ** (retry - 1)


@dataclass(frozen=True)
class CircuitBreaker:
    """Per-target consecutive-failure circuit breaker configuration.

    After ``threshold`` consecutive failures the circuit opens: the runtime
    fails new dispatches to the target fast (no draws, no occupancy) and
    fails them over. ``probation_ms`` after opening, the circuit goes
    half-open: ONE probe dispatch is admitted — success closes the circuit,
    failure re-opens it for another probation period.
    """

    threshold: int = 3
    probation_ms: float = 30_000.0

    def __post_init__(self):
        if self.threshold < 1:
            raise FaultError(
                f"breaker threshold must be >= 1, got {self.threshold!r}")
        if not self.probation_ms > 0.0:
            raise FaultError(
                f"probation_ms must be a positive duration, got "
                f"{self.probation_ms!r}")


class TargetHealth:
    """Mutable per-target health state driven by a ``CircuitBreaker`` spec.

    Lives on the runtime (like the predicted edge queues) and advances on
    the virtual clock: every dispatch outcome is reported in dispatch order,
    so the open/closed schedule is deterministic and identical across the
    batched / streaming / event-driven paths.
    """

    CLOSED, OPEN, HALF_OPEN = 0, 1, 2

    def __init__(self, breaker: CircuitBreaker):
        self.breaker = breaker
        self.consecutive: dict[str, int] = {}
        self.state: dict[str, int] = {}
        self.opened_at: dict[str, float] = {}
        self.n_opens = 0

    def any_open(self) -> bool:
        """Cheap hot-path gate: is any circuit not CLOSED? (No mutation.)"""
        return any(s != self.CLOSED for s in self.state.values())

    def dirty(self) -> bool:
        """Would success bookkeeping change anything? False when every
        circuit is closed and every consecutive-failure count is zero — the
        batched serve path uses this to skip the per-row success walk on
        all-healthy rounds (the faults-off overhead floor)."""
        return self.any_open() or any(self.consecutive.values())

    def is_open(self, target: str, now: float) -> bool:
        """True when dispatches to ``target`` should fail fast at ``now``.
        A probation-expired circuit transitions to half-open and admits the
        caller as its single probe."""
        st = self.state.get(target, self.CLOSED)
        if st == self.CLOSED:
            return False
        if st == self.OPEN and \
                now >= self.opened_at[target] + self.breaker.probation_ms:
            self.state[target] = self.HALF_OPEN
            return False  # the probe dispatch
        return st == self.OPEN

    def would_fail_fast(self, target: str, now: float) -> bool:
        """Non-mutating ``is_open``: True while the circuit is OPEN and its
        probation window has not expired (an expired circuit would admit the
        caller as its half-open probe, so it does NOT fail fast). Failover
        placement uses this to exclude open targets without burning probes."""
        st = self.state.get(target, self.CLOSED)
        return st == self.OPEN and \
            now < self.opened_at[target] + self.breaker.probation_ms

    def record_failure(self, target: str, now: float) -> None:
        n = self.consecutive.get(target, 0) + 1
        self.consecutive[target] = n
        st = self.state.get(target, self.CLOSED)
        if st == self.HALF_OPEN or \
                (st == self.CLOSED and n >= self.breaker.threshold):
            self.state[target] = self.OPEN
            self.opened_at[target] = now
            self.n_opens += 1

    def record_success(self, target: str) -> None:
        self.consecutive[target] = 0
        self.state[target] = self.CLOSED


@dataclass(frozen=True)
class SLOTier:
    """One SLO class: tasks of this tier should finish within ``deadline_ms``
    of arrival; ``sheddable`` tiers may be dropped under predicted overload
    (the top tier is typically not)."""

    deadline_ms: float
    sheddable: bool = True

    def __post_init__(self):
        if not self.deadline_ms > 0.0:
            raise FaultError(
                f"SLO tier deadline_ms must be a positive duration, got "
                f"{self.deadline_ms!r}")


@dataclass(frozen=True)
class AdmissionPolicy:
    """SLO-tiered admission control: after placement, a task whose PREDICTED
    latency already exceeds its tier's deadline headroom is shed (if its
    tier is sheddable) instead of executed — queues degrade by dropping the
    lowest classes first, not by growing without bound (LaSS-style).

    ``tiers[i]`` is the SLO class of tasks carrying ``tier == i``; tier 0 is
    the highest class. Tasks with a tier index outside the table are treated
    as the last (lowest) tier. ``headroom`` scales the deadline the shed
    test uses (``shed iff predicted > deadline * headroom``): < 1 sheds
    earlier, leaving slack for actual-vs-predicted error.
    """

    tiers: tuple[SLOTier, ...]
    headroom: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))
        if not self.tiers:
            raise FaultError(
                "AdmissionPolicy needs at least one SLOTier — an empty tier "
                "table would shed nothing and class nothing")
        if not self.headroom > 0.0:
            raise FaultError(
                f"headroom must be a positive scale factor, got "
                f"{self.headroom!r}")
        for i in range(1, len(self.tiers)):
            if self.tiers[i].deadline_ms >= self.tiers[i - 1].deadline_ms:
                raise FaultError(
                    f"tier deadlines must be strictly decreasing down the "
                    f"table (lower SLO classes carry tighter shed thresholds "
                    f"so they degrade first): tiers[{i}].deadline_ms="
                    f"{self.tiers[i].deadline_ms!r} >= tiers[{i - 1}]."
                    f"deadline_ms={self.tiers[i - 1].deadline_ms!r}")

    def shed_mask(self, tier: np.ndarray,
                  predicted_latency_ms: np.ndarray) -> np.ndarray:
        """Vectorized shed decision per task (True = drop, bill nothing)."""
        t = np.clip(np.asarray(tier, dtype=np.int64), 0, len(self.tiers) - 1)
        deadlines = np.array([s.deadline_ms for s in self.tiers])
        sheddable = np.array([s.sheddable for s in self.tiers], dtype=bool)
        return sheddable[t] & (np.asarray(predicted_latency_ms)
                               > deadlines[t] * self.headroom)

    def deadline_of(self, tier: int) -> float:
        return self.tiers[min(max(tier, 0), len(self.tiers) - 1)].deadline_ms
