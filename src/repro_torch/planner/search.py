"""What-if capacity search: replay a trace against candidate configurations.

The planner answers the operator's question directly: *what is the cheapest
fleet/policy configuration that would have served this recorded traffic
within its SLO?* Every candidate is replayed against the trace through the
real serve path — the same columnar ``serve_stream`` the production runtime
uses, via ``ShardedRuntime`` workers — and scored from the resulting record
arrays: actual cloud spend, fleet capacity cost, latency percentiles, and
SLO attainment. Nothing is approximated with queueing formulas; the digital
twin executes the trace.

Two search strategies:

- **grid** — replay every candidate against the full trace. Exhaustive, and
  embarrassingly parallel: each (candidate × app) pair is one independent
  shard, so candidates evaluate concurrently in threads or processes with
  bit-identical results in every mode.
- **halving** — successive halving over trace prefixes: replay all
  candidates on a short prefix, prune the bottom half, double the prefix,
  repeat — the final rung replays the FULL trace, so the winner is always
  verified on everything, never extrapolated from a prefix.

Every replay places on the torch placement core (``array_backend="torch"``)
on the CUDA card unless the planner is given ``device="cpu"``; without a
card the planner raises at construction. ``array_backend="numpy"`` with
``device="cpu"`` is the oracle the card's scores are held to.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.apps import APPS, MEMORY_CONFIGS_MB
from repro_torch.core.multiapp import AppShard, ShardedResult, ShardedRuntime
from repro_torch.core.records import SimulationResult
from repro_torch.planner.candidates import Candidate, TwinRuntimeFactory
from repro_torch.trace.format import Trace, TraceError
from repro_torch.trace.replay import TraceChunkFactory

MS_PER_HOUR = 3_600_000.0


@dataclass(frozen=True)
class SLO:
    """Service-level objective: ``target`` fraction of tasks within
    ``latency_ms`` (e.g. 99% of requests under 30 s end-to-end)."""

    latency_ms: float
    target: float = 0.99

    def __post_init__(self):
        if not self.latency_ms > 0:
            raise ValueError(f"SLO latency must be > 0, got {self.latency_ms}")
        if not 0.0 < self.target <= 1.0:
            raise ValueError(
                f"SLO target must be in (0, 1], got {self.target}")


@dataclass
class CandidateScore:
    """One candidate's replay outcome, scored from the record arrays."""

    candidate: Candidate
    n: int                       # tasks replayed (prefix length on early rungs)
    cloud_cost: float            # Σ actual billed cost (edge marginal = 0)
    fleet_cost: float            # device_rate_per_hour × Σspeed × makespan h
    mean_latency_ms: float
    p50_latency_ms: float
    p95_latency_ms: float
    p99_latency_ms: float
    attainment: float            # fraction of tasks within slo.latency_ms
    meets_slo: bool
    makespan_ms: float           # first arrival → last completion, cross-app
    per_app_attainment: dict[str, float] = field(default_factory=dict)

    @property
    def total_cost(self) -> float:
        return self.cloud_cost + self.fleet_cost

    def row(self) -> str:
        flag = "meets" if self.meets_slo else "MISSES"
        return (f"{self.candidate.name:<18} ${self.total_cost:>10.5f} "
                f"(cloud {self.cloud_cost:.5f} + fleet {self.fleet_cost:.5f})"
                f"  p99 {self.p99_latency_ms:>8,.0f} ms"
                f"  attain {self.attainment:7.2%}  {flag}")


def score_candidate(candidate: Candidate,
                    results: dict[str, SimulationResult],
                    slo: SLO) -> CandidateScore:
    """Score one candidate's per-app replay results against the SLO.

    All metrics are array reductions over the concatenated record columns.
    Fleet cost charges the candidate's aggregate relative capacity
    (``Σ device speeds``) at ``device_rate_per_hour`` for the run's makespan
    — so over-provisioned fleets pay for the capacity that bought their
    latency, which is the trade the planner exists to arbitrate.
    """
    lats = [r.records.actual_latency_ms for r in results.values()]
    lat = np.concatenate(lats) if lats else np.zeros(0)
    n = int(lat.shape[0])
    per_app = {
        app: float(np.count_nonzero(
            r.records.actual_latency_ms <= slo.latency_ms)) / max(r.n, 1)
        for app, r in results.items()}
    attain = float(np.count_nonzero(lat <= slo.latency_ms)) / max(n, 1)
    t0 = min((float(np.min(r.records.arrival_ms))
              for r in results.values() if r.n), default=0.0)
    t1 = max((float(np.max(r.records.completion_ms))
              for r in results.values() if r.n), default=0.0)
    makespan = max(t1 - t0, 0.0)
    fleet_cost = (candidate.device_rate_per_hour
                  * candidate.fleet_speed_total * makespan / MS_PER_HOUR)
    return CandidateScore(
        candidate=candidate,
        n=n,
        cloud_cost=float(sum(r.total_actual_cost for r in results.values())),
        fleet_cost=fleet_cost,
        mean_latency_ms=float(np.mean(lat)) if n else 0.0,
        p50_latency_ms=float(np.percentile(lat, 50)) if n else 0.0,
        p95_latency_ms=float(np.percentile(lat, 95)) if n else 0.0,
        p99_latency_ms=float(np.percentile(lat, 99)) if n else 0.0,
        attainment=attain,
        meets_slo=attain >= slo.target,
        makespan_ms=makespan,
        per_app_attainment=per_app,
    )


def _rank_key(s: CandidateScore):
    """SLO-meeting candidates first, cheapest wins; among SLO-missers,
    closest to the target wins (then cheapest). Name breaks exact ties so
    the ranking is a total order — identical across evaluation modes."""
    if s.meets_slo:
        return (0, s.total_cost, s.candidate.name)
    return (1, -s.attainment, s.total_cost, s.candidate.name)


@dataclass
class PlanResult:
    """Outcome of one ``Planner.plan`` search."""

    best: CandidateScore               # verified on the FULL trace
    scores: list[CandidateScore]       # final-rung (full-trace) scores, ranked
    rungs: list[dict]                  # per-rung summaries (halving)
    strategy: str
    mode: str
    replayed_tasks: int                # Σ tasks replayed across all rungs
    # per-shard ``stream_stats`` (kernel launches, residency counters) of
    # each replay in order: the halving rungs, the full trace, the budget
    # probes
    stream_stats: list[dict] = field(default_factory=list)

    def table(self) -> str:
        rows = [s.row() for s in self.scores]
        rows.append(f"best: {self.best.candidate.name} "
                    f"(${self.best.total_cost:.5f}, "
                    f"attain {self.best.attainment:.2%})")
        return "\n".join(rows)


class Planner:
    """Replay a trace against candidate configurations; find the cheapest
    that meets the SLO.

    Each (candidate × app) pair becomes one independent ``AppShard`` — its
    runtime a ``TwinRuntimeFactory`` (rebuilt from seeds, fit-cached), its
    workload the candidate-agnostic per-app sub-trace — so one
    ``ShardedRuntime.serve`` evaluates the whole candidate set through the
    existing worker machinery. Shards share no state; scores are
    bit-identical across sequential, thread, and process modes.

    ``array_backend`` and ``device`` go into every runtime factory (see
    ``TwinRuntimeFactory``); ``device=None`` is the CUDA card.
    """

    def __init__(self, trace: Trace, slo: SLO, fit_seed: int = 0,
                 n_inputs: int | None = 120,
                 fit_configs: tuple[int, ...] | None = None,
                 twin_seed: int = 11, max_workers: int | None = None,
                 array_backend: str = "torch", device: str | None = None):
        resolve_device(device)
        trace.validate()
        if trace.n == 0:
            raise TraceError("cannot plan over an empty trace")
        for app in trace.app_names:
            if app not in APPS:
                raise TraceError(
                    f"trace app {app!r} is not a known application; known "
                    f"apps are {sorted(APPS)}")
        self.trace = trace
        self.slo = slo
        self.fit_seed = fit_seed
        self.n_inputs = n_inputs
        if fit_configs is None:
            fit_configs = tuple(MEMORY_CONFIGS_MB)
        self.fit_configs = tuple(fit_configs)
        self.twin_seed = twin_seed
        self.max_workers = max_workers
        self.array_backend = array_backend
        self.device = device
        # the ShardedResult of the most recent evaluate(): per-shard records
        # and stream_stats (kernel launches, residency counters)
        self.last_sharded: ShardedResult | None = None

    @property
    def last_mode(self) -> str:
        """Mode of the most recent ``evaluate()``; ``"none"`` before one."""
        return "none" if self.last_sharded is None else self.last_sharded.mode

    # ------------------------------------------------------------- evaluate
    def _shards(self, candidates: list[Candidate],
                prefix_n: int | None) -> list[AppShard]:
        sub = (self.trace if prefix_n is None
               else self.trace.prefix(prefix_n)).split_by_app()
        shards = []
        for cand in candidates:
            for app, t in sub.items():
                shards.append(AppShard(
                    name=f"{cand.name}/{app}",
                    runtime=TwinRuntimeFactory(
                        app=app, candidate=cand, fit_seed=self.fit_seed,
                        n_inputs=self.n_inputs, fit_configs=self.fit_configs,
                        twin_seed=self.twin_seed,
                        array_backend=self.array_backend, device=self.device),
                    workload=TraceChunkFactory(t),
                    chunk_size=cand.chunk_size,
                    keep_tasks=False))
        return shards

    def evaluate(self, candidates, prefix_n: int | None = None,
                 parallel: bool = True,
                 use_processes: bool = False) -> list[CandidateScore]:
        """Replay every candidate against the trace (or its first
        ``prefix_n`` records); return scores ranked best-first."""
        candidates = list(candidates)
        if not candidates:
            raise ValueError("no candidates to evaluate")
        names = [c.name for c in candidates]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate candidate names: {names}")
        sharded = ShardedRuntime(
            self._shards(candidates, prefix_n),
            max_workers=self.max_workers,
        ).serve(parallel=parallel, use_processes=use_processes)
        self.last_sharded = sharded
        apps = self.trace.app_names
        scores = [
            score_candidate(
                cand,
                {app: sharded.results[f"{cand.name}/{app}"] for app in apps
                 if f"{cand.name}/{app}" in sharded.results},
                self.slo)
            for cand in candidates]
        return sorted(scores, key=_rank_key)

    # -------------------------------------------------------- budget bisect
    def _refine_budget(self, best: CandidateScore, lo: float, iters: int,
                       rel_tol: float, parallel: bool, use_processes: bool,
                       stats: list[dict]) -> tuple[CandidateScore, list]:
        """Bisect the winner's per-task budget ``c_max`` down to the cheapest
        value that still meets the SLO.

        The structural search picks a *configuration*; ``c_max`` is the one
        continuous knob left on the table, and total cost is (weakly)
        monotone in it — a smaller budget pushes work to the edge, trading
        cloud spend for latency until attainment drops below target. So the
        cheapest SLO-meeting budget sits at a threshold that bisection finds
        in O(log) full-trace replays: the invariant is that ``hi`` always
        meets the SLO (it starts at the verified winner), ``lo`` always
        misses (checked by the first probe — if the floor itself meets, it
        is returned outright). Every probe replays the FULL trace through
        ``evaluate``, so the refined winner is verified on every record,
        never interpolated.
        """
        cand, spec = best.candidate, best.candidate.policy
        if (not best.meets_slo or spec.kind == "min_cost"
                or not spec.c_max > lo):
            return best, []
        probes: list[CandidateScore] = []

        def probe(c_max: float) -> CandidateScore:
            pc = replace(cand, name=f"{cand.name}~cmax{len(probes)}",
                         policy=replace(spec, c_max=c_max))
            s = self.evaluate([pc], parallel=parallel,
                              use_processes=use_processes)[0]
            probes.append(s)
            stats.append(self.last_sharded.stream_stats)
            return s

        hi, winner = spec.c_max, best
        lo_score = probe(lo)
        if lo_score.meets_slo:
            lo_score = replace(lo_score, candidate=replace(
                lo_score.candidate, name=cand.name))
            return (min((lo_score, best), key=_rank_key), probes)
        for _ in range(max(iters, 0)):
            if hi - lo <= rel_tol * max(abs(hi), 1e-12):
                break
            mid = 0.5 * (lo + hi)
            s = probe(mid)
            if s.meets_slo:
                hi, winner = mid, s
            else:
                lo = mid
        if winner is not best:
            winner = replace(winner, candidate=replace(
                winner.candidate, name=cand.name))
            winner = min((winner, best), key=_rank_key)
        return winner, probes

    # ----------------------------------------------------------------- plan
    def plan(self, candidates, strategy: str = "grid", rungs: int = 3,
             min_rung_n: int = 512, parallel: bool = True,
             use_processes: bool = False, budget_strategy: str = "none",
             budget_lo: float = 0.0, budget_iters: int = 8,
             budget_rel_tol: float = 0.02) -> PlanResult:
        """The cheapest configuration that serves this trace within SLO.

        ``strategy="grid"`` replays every candidate on the full trace;
        ``"halving"`` prunes the bottom half of the ranking after each
        prefix rung, doubling the prefix each time — the last rung is always
        the full trace, so ``best`` is verified on every record either way.
        If no candidate meets the SLO, the best-attainment one is returned
        (``best.meets_slo`` says which case you are in).

        ``budget_strategy="bisect"`` then refines the winner's continuous
        ``c_max`` knob (min-latency/hedged policies only): bisect down to the
        cheapest budget that still meets the SLO, ``budget_iters`` probes at
        most, stopping once the bracket is within ``budget_rel_tol`` of the
        meeting endpoint. Probes replay the full trace, and the refined
        winner keeps the original candidate name — it is the same
        configuration with a tighter budget.
        """
        candidates = list(candidates)
        if strategy not in ("grid", "halving"):
            raise ValueError(
                f"unknown strategy {strategy!r}; expected 'grid' or 'halving'")
        if budget_strategy not in ("none", "bisect"):
            raise ValueError(
                f"unknown budget_strategy {budget_strategy!r}; expected "
                f"'none' or 'bisect'")
        rung_log: list[dict] = []
        stats: list[dict] = []
        replayed = 0
        survivors = candidates
        if strategy == "halving" and rungs > 1 and len(candidates) > 1:
            n = self.trace.n
            for k in range(rungs - 1):
                rung_n = max(min_rung_n, n >> (rungs - 1 - k))
                if rung_n >= n:
                    break  # prefix would not be shorter than the full trace
                ranked = self.evaluate(survivors, prefix_n=rung_n,
                                       parallel=parallel,
                                       use_processes=use_processes)
                stats.append(self.last_sharded.stream_stats)
                replayed += sum(s.n for s in ranked)
                keep = max(1, math.ceil(len(ranked) / 2))
                rung_log.append({
                    "rung": k, "prefix_n": rung_n,
                    "evaluated": [s.candidate.name for s in ranked],
                    "kept": [s.candidate.name for s in ranked[:keep]]})
                survivors = [s.candidate for s in ranked[:keep]]
        final = self.evaluate(survivors, prefix_n=None, parallel=parallel,
                              use_processes=use_processes)
        stats.append(self.last_sharded.stream_stats)
        replayed += sum(s.n for s in final)
        best = final[0]
        if budget_strategy == "bisect":
            best, probes = self._refine_budget(
                best, budget_lo, budget_iters, budget_rel_tol, parallel,
                use_processes, stats)
            replayed += sum(s.n for s in probes)
            for i, s in enumerate(probes):
                rung_log.append({
                    "budget_probe": i, "c_max": s.candidate.policy.c_max,
                    "total_cost": s.total_cost, "attainment": s.attainment,
                    "meets_slo": s.meets_slo})
        return PlanResult(best=best, scores=final, rungs=rung_log,
                          strategy=strategy, mode=self.last_mode,
                          replayed_tasks=replayed, stream_stats=stats)


def plan(trace: Trace, candidates, slo: SLO, strategy: str = "grid",
         **kwargs) -> PlanResult:
    """Convenience: ``Planner(trace, slo).plan(candidates, strategy)``.

    Planner construction kwargs (``fit_seed``, ``n_inputs``, ``twin_seed``,
    ``max_workers``, ``fit_configs``, ``array_backend``, ``device``) and plan
    kwargs (``rungs``,
    ``parallel``, ``use_processes``, ``min_rung_n``, ``budget_strategy``,
    ``budget_lo``, ``budget_iters``, ``budget_rel_tol``) are split
    automatically.
    """
    plan_keys = {"rungs", "min_rung_n", "parallel", "use_processes",
                 "budget_strategy", "budget_lo", "budget_iters",
                 "budget_rel_tol"}
    plan_kw = {k: v for k, v in kwargs.items() if k in plan_keys}
    ctor_kw = {k: v for k, v in kwargs.items() if k not in plan_keys}
    return Planner(trace, slo, **ctor_kw).plan(candidates, strategy=strategy,
                                               **plan_kw)
