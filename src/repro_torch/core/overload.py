"""Overload survival: predictive container pre-warming + fair-share tier
reclamation.

Two policies, both optional, both off by default (``PlacementRuntime(...,
prewarm=None, reclamation=None)`` is bit-identical per record to a runtime
built without them):

**Predictive pre-warming** (context-aware orchestration, PAPERS.md): a
streaming burst forecaster watches the arrival-gap process — a fast EWMA of
recent inter-arrival gaps against a slow quiet-regime baseline — and flags
the quiet→burst regime switch of an MMPP source (``BurstyWorkload``) a few
arrivals into the burst, while the cold-start storm is still ahead. On each
trigger the runtime spawns ``PrewarmPolicy.count`` containers per cloud
configuration via ``ContainerInfoList.prewarm`` (client-side shadow) and
``GroundTruthCloud.spinup`` (twin ground truth), warm for
``keepalive_ms`` past their spin-up; the idle keep-alive retainer is debited
from the Alg. 1 surplus bank exactly once per container, at spawn.

**Fair-share reclamation** (LaSS, PAPERS.md): when a device's predicted
queue horizon pushes top-tier (tier 0) predicted latencies past their
deadline headroom, lower-tier work already *placed* on that device — not
just new arrivals at the admission door — is preempted and re-placed through
the columnar ``failover_choice`` path with the pressured device masked.
Each tier owns a share of a device's compute; only compute *beyond* a
tier's fair share is reclaimable, lowest class first. Preempted tasks are
demoted one SLO class when the move (or forced stay) costs them their old
deadline — recorded first-class as ``RecordBatch.downgraded``.

Determinism contract (PR 8's, extended): the forecaster is a pure scalar
fold over arrival gaps with its state carried across chunks, so feeding one
chunk of N arrivals or N chunks of 1 produces bit-identical state and the
identical spawn schedule — which is what makes the prewarm/preempt/downgrade
schedule reproducible across ``serve`` / ``serve_stream`` (any chunking) /
``serve_async`` for a fixed seed. Victim selection is a pure function of
the (deterministic) placement batch. Nothing here draws randomness.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.faults import FaultError, SLOTier


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise FaultError(msg)


@dataclass(frozen=True)
class PrewarmPolicy:
    """Configuration of the predictive pre-warmer.

    ``count`` containers are spawned per target on every burst trigger;
    ``targets=None`` means every cloud configuration the predictor knows.
    ``spinup_ms=None`` asks the runtime for the backend's cold-start mean
    (the honest "containers take this long to come up" figure). The
    remaining fields parameterize the ``BurstForecaster``.
    """

    count: int = 2
    targets: tuple[str, ...] | None = None
    keepalive_ms: float = 60_000.0
    spinup_ms: float | None = None
    # forecaster knobs — see BurstForecaster
    alpha: float = 0.2
    baseline_alpha: float = 0.02
    ratio: float = 3.0
    exit_ratio: float = 1.5
    min_gaps: int = 16
    cooldown_ms: float = 1_000.0

    def __post_init__(self):
        if self.targets is not None:
            object.__setattr__(self, "targets", tuple(self.targets))
        _require(self.count >= 1,
                 f"prewarm count must be >= 1 container per trigger, got "
                 f"{self.count!r}")
        _require(np.isfinite(self.keepalive_ms) and self.keepalive_ms > 0.0,
                 f"keepalive_ms must be a finite positive duration, got "
                 f"{self.keepalive_ms!r}")
        _require(self.spinup_ms is None
                 or (np.isfinite(self.spinup_ms) and self.spinup_ms >= 0.0),
                 f"spinup_ms must be None (use the backend's cold-start "
                 f"mean) or a finite non-negative duration, got "
                 f"{self.spinup_ms!r}")
        for nm, v in (("alpha", self.alpha),
                      ("baseline_alpha", self.baseline_alpha)):
            _require(0.0 < v <= 1.0,
                     f"{nm} must be an EWMA weight in (0, 1], got {v!r}")
        _require(np.isfinite(self.ratio) and self.ratio > 1.0,
                 f"ratio must be finite and > 1 (gaps must shrink below the "
                 f"baseline to signal a burst), got {self.ratio!r}")
        _require(np.isfinite(self.exit_ratio)
                 and 1.0 <= self.exit_ratio < self.ratio,
                 f"exit_ratio must satisfy 1 <= exit_ratio < ratio "
                 f"(hysteresis — exiting must be easier than entering), got "
                 f"exit_ratio={self.exit_ratio!r} vs ratio={self.ratio!r}")
        _require(self.min_gaps >= 1,
                 f"min_gaps must be >= 1 warm-up gap, got {self.min_gaps!r}")
        _require(np.isfinite(self.cooldown_ms) and self.cooldown_ms >= 0.0,
                 f"cooldown_ms must be a finite non-negative duration, got "
                 f"{self.cooldown_ms!r}")


@dataclass(frozen=True)
class ReclamationPolicy:
    """Per-``SLOTier`` fair shares for overload reclamation.

    ``tiers[i]`` is the SLO class of tasks carrying ``tier == i`` (0 =
    highest, deadlines strictly decreasing down the table, exactly as
    ``AdmissionPolicy``). ``shares[i]`` is tier i's claim on each device's
    compute: only a tier's compute *beyond* ``shares[i] / sum(shares)`` of
    the device total may be reclaimed when tier 0 is pressured.
    ``headroom`` scales the tier-0 deadline the pressure test uses (< 1
    reclaims earlier).
    """

    tiers: tuple[SLOTier, ...]
    shares: tuple[float, ...]
    headroom: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))
        object.__setattr__(
            self, "shares", tuple(float(s) for s in self.shares))
        _require(len(self.tiers) >= 2,
                 f"ReclamationPolicy needs at least two SLOTiers — with one "
                 f"class there is nothing to reclaim from, got "
                 f"{len(self.tiers)}")
        _require(len(self.shares) == len(self.tiers),
                 f"shares must give one weight per tier: got "
                 f"{len(self.shares)} shares for {len(self.tiers)} tiers")
        for i, s in enumerate(self.shares):
            _require(np.isfinite(s) and s > 0.0,
                     f"shares[{i}] must be a finite positive weight, got "
                     f"{s!r}")
        _require(np.isfinite(self.headroom) and self.headroom > 0.0,
                 f"headroom must be a finite positive scale factor, got "
                 f"{self.headroom!r}")
        for i in range(1, len(self.tiers)):
            _require(
                self.tiers[i].deadline_ms < self.tiers[i - 1].deadline_ms,
                f"tier deadlines must be strictly decreasing down the table "
                f"(lower SLO classes carry tighter thresholds so they "
                f"degrade first): tiers[{i}].deadline_ms="
                f"{self.tiers[i].deadline_ms!r} >= tiers[{i - 1}]."
                f"deadline_ms={self.tiers[i - 1].deadline_ms!r}")

    def deadline_of(self, tier: int) -> float:
        return self.tiers[min(max(tier, 0), len(self.tiers) - 1)].deadline_ms


@dataclass
class BurstForecaster:
    """Streaming quiet/burst regime detector over inter-arrival gaps.

    Two EWMAs of the gap sequence: ``fast`` (weight ``alpha``) tracks the
    current arrival rate, ``slow`` (weight ``baseline_alpha``) tracks the
    quiet-regime baseline and is FROZEN while a burst is in progress (so a
    long burst cannot drag the baseline down and mask itself). Quiet →
    burst when ``fast * ratio < slow`` after at least ``min_gaps`` gaps;
    burst → quiet when ``fast * exit_ratio >= slow``. Each quiet→burst
    transition emits one spawn trigger, rate-limited by ``cooldown_ms``.

    ``feed`` is a plain scalar fold: state after feeding one chunk of N
    arrivals is bit-identical to feeding the same arrivals in any chunking
    — the property the cross-serve-path schedule-identity contract rests
    on. (A vectorized closed-form EWMA would drift from the fold in the
    last ulp and could flip a threshold crossing at one chunking but not
    another.) The fold only runs when pre-warming is armed; policies-off
    serves never construct one.
    """

    alpha: float = 0.2
    baseline_alpha: float = 0.02
    ratio: float = 3.0
    exit_ratio: float = 1.5
    min_gaps: int = 16
    cooldown_ms: float = 1_000.0
    # streaming state (carried across chunks / serve calls)
    last_t: float | None = None
    fast: float | None = None
    slow: float | None = None
    n_gaps: int = 0
    in_burst: bool = False
    last_spawn: float = float("-inf")
    n_triggers: int = 0

    @classmethod
    def from_policy(cls, p: PrewarmPolicy) -> "BurstForecaster":
        return cls(alpha=p.alpha, baseline_alpha=p.baseline_alpha,
                   ratio=p.ratio, exit_ratio=p.exit_ratio,
                   min_gaps=p.min_gaps, cooldown_ms=p.cooldown_ms)

    def feed(self, arrival_ms) -> list[float]:
        """Fold a chunk of arrival times (nondecreasing within and across
        chunks); returns the spawn-trigger times fired inside this chunk."""
        times = np.asarray(arrival_ms, dtype=np.float64)
        if times.size == 0:
            return []
        triggers: list[float] = []
        # locals for the hot fold (only runs when pre-warming is armed)
        a, b = self.alpha, self.baseline_alpha
        ratio, exit_ratio = self.ratio, self.exit_ratio
        min_gaps, cooldown = self.min_gaps, self.cooldown_ms
        last_t, fast, slow = self.last_t, self.fast, self.slow
        n_gaps, in_burst, last_spawn = \
            self.n_gaps, self.in_burst, self.last_spawn
        for t in times.tolist():
            if last_t is None:
                last_t = t
                continue
            g = t - last_t
            if g < 0.0:
                g = 0.0  # defensive: out-of-order feed degrades gracefully
            last_t = t
            if fast is None:
                fast = slow = g  # seed both EWMAs with the first gap
                n_gaps = 1
                continue
            fast += a * (g - fast)
            n_gaps += 1
            if in_burst:
                if fast * exit_ratio >= slow:
                    in_burst = False
                continue
            slow += b * (g - slow)
            if n_gaps >= min_gaps and fast * ratio < slow:
                in_burst = True
                if t - last_spawn >= cooldown:
                    last_spawn = t
                    triggers.append(t)
        self.last_t, self.fast, self.slow = last_t, fast, slow
        self.n_gaps, self.in_burst, self.last_spawn = \
            n_gaps, in_burst, last_spawn
        self.n_triggers += len(triggers)
        return triggers


def select_victims(policy: ReclamationPolicy, *, codes: np.ndarray,
                   tier: np.ndarray, latency_ms: np.ndarray,
                   comp_ms: np.ndarray, active: np.ndarray,
                   n_cloud: int, n_targets: int) -> np.ndarray:
    """Pick the rows fair-share reclamation preempts from a placement batch.

    Pure function of the (deterministic) columnar decision — no state, no
    randomness — which is what makes the preempt schedule reproducible
    across serve paths. Per edge device (fleet order):

    - the device is *pressured* when any tier-0 row placed on it predicts
      latency beyond ``tiers[0].deadline_ms * headroom``;
    - the relief target is the worst such overshoot;
    - eligible victims are lower-tier rows placed on the device that arrive
      no later than the last pressured row (work behind the pressure point
      cannot relieve it);
    - tiers are drained lowest class first, each capped at its compute
      beyond its fair share of the device total, earliest arrivals first.

    Returns victim row indices, ascending (= arrival order).
    """
    nt = len(policy.tiers)
    t = np.clip(np.asarray(tier, dtype=np.int64), 0, nt - 1)
    pressure_ms = policy.tiers[0].deadline_ms * policy.headroom
    shares = np.asarray(policy.shares, dtype=np.float64)
    share_frac = shares / shares.sum()
    victims: list[int] = []
    for dev_code in range(n_cloud, n_targets):
        rows = np.nonzero(active & (codes == dev_code))[0]
        if rows.size == 0:
            continue
        rt = t[rows]
        pressured = rows[(rt == 0) & (latency_ms[rows] > pressure_ms)]
        if pressured.size == 0:
            continue
        relief = float(np.max(latency_ms[pressured])) - pressure_ms
        eligible = rows[rows <= pressured[-1]]
        total_comp = float(np.sum(comp_ms[rows]))
        for tv in range(nt - 1, 0, -1):
            if relief <= 0.0:
                break
            cand = eligible[t[eligible] == tv]
            if cand.size == 0:
                continue
            cap = float(np.sum(comp_ms[cand])) - share_frac[tv] * total_comp
            for r in cand.tolist():
                if relief <= 0.0 or cap <= 0.0:
                    break
                victims.append(r)
                c = float(comp_ms[r])
                relief -= c
                cap -= c
    return np.array(sorted(victims), dtype=np.int64)


@dataclass
class _PrewarmEntry:
    """Live bookkeeping for one speculatively spawned container."""

    target: str
    spawned_ms: float
    ready_ms: float
    expires_ms: float
    cost: float
    cil_rec: object  # the ContainerRecord (stable identity in the CIL)


class OverloadManager:
    """Runtime-side holder of the overload policies and their audit trails.

    Owns the forecaster (streaming state) plus two append-only ledgers the
    schedule-identity tests compare across serve paths:

    - ``prewarm_log``: ``(trigger_ms, target, ready_ms, expires_ms, cost)``
      per spawned container (cost already debited from the surplus bank —
      exactly once, at spawn);
    - ``reclaim_log``: ``(now_ms, task_idx, src, dst, tier_from, tier_to,
      moved, downgraded)`` per preempted task (``dst == src`` and
      ``moved=False`` when every alternative was excluded and the task was
      forcibly kept in place, demoted).
    """

    def __init__(self, prewarm: PrewarmPolicy | None = None,
                 reclamation: ReclamationPolicy | None = None):
        if prewarm is None and reclamation is None:
            raise FaultError(
                "OverloadManager needs a PrewarmPolicy, a ReclamationPolicy, "
                "or both — with neither it would do nothing")
        self.prewarm = prewarm
        self.reclamation = reclamation
        self.forecaster = (BurstForecaster.from_policy(prewarm)
                           if prewarm is not None else None)
        self.prewarm_log: list[tuple] = []
        self.reclaim_log: list[tuple] = []
        self.active_prewarms: list[_PrewarmEntry] = []
        self.n_extensions = 0

    def feed_arrivals(self, arrival_ms) -> list[float]:
        """Advance the burst forecaster; returns spawn-trigger times."""
        if self.forecaster is None:
            return []
        return self.forecaster.feed(arrival_ms)

    def record_spawn(self, trigger_ms: float, target: str, ready_ms: float,
                     expires_ms: float, cost: float, cil_rec) -> None:
        """Ledger one spawned container (the runtime already debited it)."""
        self.prewarm_log.append(
            (trigger_ms, target, ready_ms, expires_ms, cost))
        self.active_prewarms.append(_PrewarmEntry(
            target=target, spawned_ms=trigger_ms, ready_ms=ready_ms,
            expires_ms=expires_ms, cost=cost, cil_rec=cil_rec))

    def reap_prewarms(self, now: float) -> None:
        """Drop bookkeeping for keep-alive windows that have passed (the CIL
        reaps its own records; this trims the extension candidates)."""
        if self.active_prewarms:
            self.active_prewarms = [
                e for e in self.active_prewarms if e.expires_ms > now]
