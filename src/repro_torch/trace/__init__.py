"""Versioned traffic traces: ingestion, bit-exact replay, and capture.

The bridge between recorded traffic and the simulator: load a trace
(JSONL or NPZ, validated with the offending record named), replay it through
``PlacementRuntime.serve_stream`` bit-identically to an in-memory workload,
and capture any served run back out as a trace — round-trip exact. The
what-if capacity planner (``repro_torch.planner``) replays these traces against
candidate fleet/policy configurations.
"""

from repro_torch.trace.format import (
    TRACE_SCHEMA,
    TRACE_SCHEMA_VERSION,
    Trace,
    TraceError,
    load,
    load_jsonl,
    load_npz,
    merge,
)
from repro_torch.trace.replay import (
    TraceChunkFactory,
    TraceWorkload,
    capture,
    capture_sharded,
    fault_spec_of,
    trace_shards,
)

__all__ = [
    "TRACE_SCHEMA",
    "TRACE_SCHEMA_VERSION",
    "Trace",
    "TraceError",
    "TraceChunkFactory",
    "TraceWorkload",
    "capture",
    "capture_sharded",
    "fault_spec_of",
    "load",
    "load_jsonl",
    "load_npz",
    "merge",
    "trace_shards",
]
