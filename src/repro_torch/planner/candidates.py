"""What-if candidates: one serving configuration a trace can replay against.

A ``Candidate`` names everything the platform operator can actually turn:
the edge fleet (device count / speed mix), the placement policy and its
budget or deadline, the cloud memory-configuration set offered to the
policy, and the serve chunk size. ``TwinRuntimeFactory`` turns a candidate
into a live ``PlacementRuntime`` for one application — as a picklable,
zero-argument callable, because that is exactly what
``ShardedRuntime(use_processes=True)`` requires of its shards: the spawned
child process rebuilds the runtime from the spec rather than unpickling live
model state. Fitting is deterministic from seeds and cached per process, so
sequential, thread, and process evaluations of the same candidate produce
bit-identical records.

The runtimes a factory builds place on the torch placement core
(``array_backend="torch"``) on the CUDA card by default; ``device="cpu"``
runs them on the CPU, on request only (``repro_torch.resolve_device``).
Both are kept as strings so that the factory pickles for a spawned child.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

from repro_torch import resolve_device
from repro_torch.core.apps import APPS, AWSTwin, MEMORY_CONFIGS_MB
from repro_torch.core.decision import (
    DecisionEngine,
    HedgedPolicy,
    MinCostPolicy,
    MinLatencyPolicy,
    Policy,
)
from repro_torch.core.fit import FittedModels, build_fleet_predictor, fit_app
from repro_torch.core.runtime import PlacementRuntime, TwinBackend

_POLICY_KINDS = ("min_cost", "min_latency", "hedged")


@dataclass(frozen=True)
class PolicySpec:
    """Declarative, picklable spelling of a placement policy.

    Policies carry mutable per-run state (the min-latency surplus bank), so a
    candidate cannot hold a live ``Policy`` — every runtime gets a fresh
    instance from ``build()``.
    """

    kind: str = "min_latency"         # min_cost | min_latency | hedged
    deadline_ms: float = 1000.0       # min_cost: per-task deadline δ
    c_max: float = 0.0                # min_latency/hedged: per-task budget
    alpha: float = 0.0                # surplus carryover factor
    hedge_threshold_ms: float = 0.0   # hedged: tail-risk trigger

    def __post_init__(self):
        if self.kind not in _POLICY_KINDS:
            raise ValueError(
                f"unknown policy kind {self.kind!r}; expected one of "
                f"{_POLICY_KINDS}")

    def build(self) -> Policy:
        if self.kind == "min_cost":
            return MinCostPolicy(deadline_ms=self.deadline_ms)
        inner = MinLatencyPolicy(c_max=self.c_max, alpha=self.alpha)
        if self.kind == "hedged":
            return HedgedPolicy(inner,
                                hedge_threshold_ms=self.hedge_threshold_ms)
        return inner

    @property
    def deadline_for_result(self) -> float | None:
        return self.deadline_ms if self.kind == "min_cost" else None

    @property
    def c_max_for_result(self) -> float | None:
        return self.c_max if self.kind != "min_cost" else None


@dataclass(frozen=True)
class Candidate:
    """One serving configuration the planner can replay a trace against.

    ``fleet`` is a tuple of ``(device_name, relative_speed)`` pairs — the
    hashable/picklable spelling of the ``build_fleet_predictor`` device
    mapping. ``device_rate_per_hour`` prices fleet capacity for the planner's
    total-cost ranking: a device at speed ``s`` costs ``rate × s`` per hour
    (capacity-proportional), on top of the run's actual cloud spend.
    """

    name: str
    fleet: tuple[tuple[str, float], ...]
    policy: PolicySpec = field(default_factory=PolicySpec)
    cloud_configs: tuple[int, ...] = tuple(MEMORY_CONFIGS_MB)
    chunk_size: int = 65536
    device_rate_per_hour: float = 0.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("candidate needs a non-empty name")
        if not self.fleet:
            raise ValueError(f"candidate {self.name!r} has an empty fleet")
        names = [d for d, _ in self.fleet]
        if len(set(names)) != len(names):
            raise ValueError(
                f"candidate {self.name!r} has duplicate fleet devices: {names}")
        if self.chunk_size < 1:
            raise ValueError(
                f"candidate {self.name!r}: chunk_size must be >= 1")

    @classmethod
    def make(cls, name: str, fleet: "int | Mapping[str, float]",
             policy: PolicySpec | None = None, prefix: str = "edge",
             **kwargs) -> "Candidate":
        """Normalize a device count or ``name -> speed`` mapping into a
        candidate (count ``k`` becomes ``prefix0..prefix{k-1}`` at speed 1)."""
        if isinstance(fleet, int):
            if fleet < 1:
                raise ValueError(f"candidate {name!r}: fleet count must be >= 1")
            devices = tuple((f"{prefix}{i}", 1.0) for i in range(fleet))
        else:
            devices = tuple((str(d), float(s)) for d, s in fleet.items())
        return cls(name=name, fleet=devices,
                   policy=policy or PolicySpec(), **kwargs)

    def fleet_dict(self) -> dict[str, float]:
        return dict(self.fleet)

    @property
    def fleet_speed_total(self) -> float:
        """Aggregate relative capacity — what the hourly rate is charged on."""
        return float(sum(s for _, s in self.fleet))


# ---------------------------------------------------------------- fit cache
# Deterministic from its key, so every process (parent or spawned child)
# converges to identical models — the foundation of cross-mode determinism.
# Forked children inherit the parent's cache for free; spawn-based platforms
# re-import this module with an empty dict and lazily refit.
_FIT_CACHE: dict = {}


def fitted(app: str, seed: int = 0, n_inputs: int | None = 120,
           configs: tuple[int, ...] = tuple(MEMORY_CONFIGS_MB),
           ) -> tuple[AWSTwin, FittedModels]:
    """Cached ``fit_app`` — one (twin, models) pair per distinct fit key."""
    if app not in APPS:
        raise ValueError(
            f"unknown app {app!r}; known apps are {sorted(APPS)}")
    key = (app, seed, n_inputs, tuple(configs))
    if key not in _FIT_CACHE:
        _FIT_CACHE[key] = fit_app(app, seed=seed, n_inputs=n_inputs,
                                  configs=tuple(configs))
    return _FIT_CACHE[key]


@dataclass(frozen=True)
class TwinRuntimeFactory:
    """Picklable zero-arg ``PlacementRuntime`` factory: (app, candidate).

    The shard-runtime spelling ``ShardedRuntime`` needs for process mode, and
    equally usable live in thread/sequential mode. Everything is rebuilt from
    seeds via the module fit cache, so two invocations anywhere produce
    runtimes whose serves are bit-identical.

    ``array_backend`` and ``device`` go to the ``DecisionEngine`` it builds:
    ``device=None`` is the CUDA card and raises without one (here, at
    construction, and again in a child that has none), ``"cpu"`` runs on
    the CPU. Both stay strings so the factory pickles under spawn.
    """

    app: str
    candidate: Candidate
    fit_seed: int = 0
    n_inputs: int | None = 120
    fit_configs: tuple[int, ...] = tuple(MEMORY_CONFIGS_MB)
    twin_seed: int = 11
    array_backend: str = "torch"
    device: str | None = None

    def __post_init__(self):
        resolve_device(self.device)

    def __call__(self) -> PlacementRuntime:
        twin, models = fitted(self.app, seed=self.fit_seed,
                              n_inputs=self.n_inputs,
                              configs=self.fit_configs)
        cand = self.candidate
        fleet = cand.fleet_dict()
        predictor = build_fleet_predictor(models, fleet,
                                          configs=cand.cloud_configs)
        engine = DecisionEngine(predictor=predictor,
                                policy=cand.policy.build(), columnar=True,
                                array_backend=self.array_backend,
                                device=self.device)
        backend = TwinBackend(twin, seed=self.twin_seed,
                              edge_names=tuple(fleet), edge_speed=fleet)
        return PlacementRuntime(engine, backend)
