"""Deprecated alias: the simulator IS ``PlacementRuntime`` over ``TwinBackend``.

Kept only so pre-runtime call sites (``Simulation(twin, engine, seed).run(...)``)
keep working; it carries no bookkeeping of its own. New code:

    runtime = PlacementRuntime(engine, TwinBackend(twin, seed=seed))
    result = runtime.serve(tasks)          # or runtime.serve_async(tasks)

The engine computes where it was built to (``DecisionEngine(device=...)``:
the CUDA card unless it was given ``"cpu"``).

``TaskRecord``/``SimulationResult`` live in ``repro_torch.core.records`` and
``GroundTruthCloud`` in ``repro_torch.core.runtime``; both are re-exported
here for backward compatibility.
"""

from __future__ import annotations

import warnings

from repro_torch.core.apps import AWSTwin
from repro_torch.core.decision import DecisionEngine
from repro_torch.core.pricing import LambdaPricing
from repro_torch.core.records import RecordBatch, SimulationResult, TaskRecord  # noqa: F401
from repro_torch.core.runtime import (  # noqa: F401 — re-exports
    GTContainer,
    GroundTruthCloud,
    PlacementRuntime,
    TwinBackend,
)

__all__ = [
    "GTContainer",
    "GroundTruthCloud",
    "RecordBatch",
    "Simulation",
    "SimulationResult",
    "TaskRecord",
]


class Simulation(PlacementRuntime):
    """Deprecated alias of ``PlacementRuntime(engine, TwinBackend(twin))``."""

    def __init__(self, twin: AWSTwin, engine: DecisionEngine, seed: int = 0,
                 pricing: LambdaPricing | None = None):
        warnings.warn(
            "repro_torch.core.simulator.Simulation is deprecated; use "
            "PlacementRuntime(engine, TwinBackend(twin, seed=seed))",
            DeprecationWarning, stacklevel=2)
        super().__init__(engine, TwinBackend(
            twin, seed=seed, pricing=pricing, edge_name=engine.edge_name,
            edge_names=engine.edge_names or None))

    run = PlacementRuntime.serve
    # pre-runtime attribute spellings, all views of the backend
    twin = property(lambda self: self.backend.twin)
    gt_cloud = property(lambda self: self.backend.gt_cloud)
    pricing = property(lambda self: self.backend.pricing)
    runtime = property(lambda self: self)
