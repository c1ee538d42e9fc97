"""The placement system of the port (paper: dynamic task placement for
edge-cloud serverless), module by module like ``repro.core``, with the same
public names re-exported here:

- ``pricing``, ``perf_models``, ``gbrt``, ``cil``, ``recurrence``,
  ``workload``, ``apps``, ``fit``, ``records``, ``events``, ``faults``,
  ``overload`` — host-side numpy, own copies of the reference modules (the
  twin's numpy RNG streams are what make per-record parity possible);
- ``convert`` — fitted models carried across as plain numpy arrays;
- ``predictor`` — the Predictor; its batched GBRT column runs the CUDA
  ensemble kernel when its ``device`` is a CUDA device;
- ``decision`` — the Decision Engine; ``array_backend="torch"`` routes each
  chunk through ``torch_core``;
- ``torch_core`` — the device placement core: predict -> sequential walk ->
  one verifying replay, over the state-walk, state-replay, linear-scan and
  GBRT kernels, with cross-chunk residency;
- ``runtime`` — ``PlacementRuntime`` and the AWS twin backend, with the
  synchronous ``serve``, the event-driven ``serve_async`` and the chunked
  ``serve_stream``; each runs on ``array_backend="torch"`` and ``device=``;
- ``multiapp`` — cross-application sharded serving: N independent app
  streams (``AppShard``) in threads or spawned processes;
- ``simulator`` — deprecated alias kept for backward compatibility.

Importing this package compiles no kernel and imports no kernel library.
"""

from repro_torch.core.pricing import LambdaPricing, EdgePricing, SlicePricing
from repro_torch.core.perf_models import RidgeModel, NormalModel, ScaledModel, fit_ridge
from repro_torch.core.gbrt import GBRT, GBRTConfig
from repro_torch.core.cil import ContainerInfoList, ContainerRecord
from repro_torch.core.predictor import EdgeFleet, Predictor, Prediction, PredictionBatch
from repro_torch.core.decision import (
    DecisionBatch,
    DecisionEngine,
    EdgeBalancer,
    HedgedPolicy,
    LeastPredictedWaitBalancer,
    MinCostPolicy,
    MinLatencyPolicy,
    PlacementDecision,
    Policy,
    PolicyConstraints,
    PredictedEdgeQueue,
    RandomBalancer,
    RoundRobinBalancer,
)
from repro_torch.core.workload import (
    BurstyWorkload,
    PoissonWorkload,
    TaskChunk,
    TaskInput,
    task_arrays,
)
from repro_torch.core.records import (
    DeviceSummary,
    RecordArena,
    RecordBatch,
    SimulationResult,
    TaskRecord,
)
from repro_torch.core.multiapp import (
    AppShard,
    ShardedResult,
    ShardedRuntime,
    serve_sharded,
)
from repro_torch.core.faults import (
    AdmissionPolicy,
    Blackout,
    CircuitBreaker,
    ColdSpike,
    FaultError,
    FaultSpec,
    OutageWindow,
    RetryPolicy,
    SLOTier,
    Straggler,
    TargetHealth,
    TransientErrors,
)
from repro_torch.core.overload import (
    BurstForecaster,
    OverloadManager,
    PrewarmPolicy,
    ReclamationPolicy,
    select_victims,
)
from repro_torch.core.recurrence import fifo_starts
from repro_torch.core.events import Event, EventHeap, SingleSlotWorker
from repro_torch.core.runtime import (
    ExecutionBackend,
    ExecutionBatch,
    ExecutionOutcome,
    GroundTruthCloud,
    PlacementRuntime,
    TwinBackend,
)
from repro_torch.core.simulator import Simulation

__all__ = [
    "LambdaPricing",
    "EdgePricing",
    "SlicePricing",
    "RidgeModel",
    "NormalModel",
    "ScaledModel",
    "fit_ridge",
    "EdgeFleet",
    "EdgeBalancer",
    "LeastPredictedWaitBalancer",
    "RoundRobinBalancer",
    "RandomBalancer",
    "BurstyWorkload",
    "DeviceSummary",
    "GBRT",
    "GBRTConfig",
    "ContainerInfoList",
    "ContainerRecord",
    "Predictor",
    "Prediction",
    "PredictionBatch",
    "DecisionBatch",
    "DecisionEngine",
    "HedgedPolicy",
    "MinCostPolicy",
    "MinLatencyPolicy",
    "PlacementDecision",
    "Policy",
    "PolicyConstraints",
    "PredictedEdgeQueue",
    "AdmissionPolicy",
    "Blackout",
    "CircuitBreaker",
    "ColdSpike",
    "FaultError",
    "FaultSpec",
    "OutageWindow",
    "RetryPolicy",
    "SLOTier",
    "Straggler",
    "TargetHealth",
    "TransientErrors",
    "BurstForecaster",
    "OverloadManager",
    "PrewarmPolicy",
    "ReclamationPolicy",
    "select_victims",
    "PoissonWorkload",
    "TaskChunk",
    "TaskInput",
    "task_arrays",
    "RecordArena",
    "RecordBatch",
    "SimulationResult",
    "TaskRecord",
    "AppShard",
    "ShardedResult",
    "ShardedRuntime",
    "serve_sharded",
    "Event",
    "EventHeap",
    "SingleSlotWorker",
    "ExecutionBackend",
    "ExecutionBatch",
    "fifo_starts",
    "ExecutionOutcome",
    "GroundTruthCloud",
    "PlacementRuntime",
    "TwinBackend",
    "Simulation",
]
