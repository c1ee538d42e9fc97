"""Serving: step builders, live slice executors, and the placement service.

The port of ``repro.serving``.

``engine``    — prefill/decode step builders, the CUDA-graph decode step and
                a batched generation loop.
``executors`` — the fleet's executor pool: slice configs λ_m whose cold start
                draws the weights on the device, warms the steps up and
                captures the decode graph, plus the always-on edge executor
                with a FIFO queue.
``placement`` — the paper's framework instantiated over the slice catalog:
                SliceTarget performance models, calibration (fit), the
                ``LiveBackend`` execution backend, and ``make_live_runtime``
                which wires it all into the unified
                ``repro_torch.core.runtime.PlacementRuntime`` serve loop.
"""

from repro_torch.serving.engine import (
    batch_prompts,
    generate,
    make_compiled_steps,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.serving.executors import (
    ExecutorPool,
    LiveExecutor,
    NetworkProfile,
    SliceSpec,
    make_pool,
)
from repro_torch.serving.placement import (
    LiveBackend,
    LivePlacementServer,
    SliceCatalog,
    SliceTarget,
    build_slice_predictor,
    calibrate_catalog,
    llm_workload,
    make_live_runtime,
)

__all__ = [
    "make_compiled_steps", "make_decode_step", "make_prefill_step",
    "generate", "batch_prompts",
    "SliceSpec", "NetworkProfile", "LiveExecutor", "ExecutorPool", "make_pool",
    "SliceTarget", "SliceCatalog", "calibrate_catalog",
    "build_slice_predictor", "llm_workload", "LiveBackend",
    "LivePlacementServer", "make_live_runtime",
]
