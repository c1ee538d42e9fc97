"""What-if capacity planning: replay a trace against candidate configs.

``plan(trace, candidates, slo)`` answers "what is the cheapest fleet/policy
configuration that would have served this recorded traffic within SLO?" —
every candidate replayed through the real serve path (``ShardedRuntime``
workers over per-app sub-traces, on the torch placement core on the CUDA
card unless ``device="cpu"`` is asked for) and scored from the record
arrays.
"""

from repro_torch.planner.candidates import (
    Candidate,
    PolicySpec,
    TwinRuntimeFactory,
    fitted,
)
from repro_torch.planner.search import (
    SLO,
    CandidateScore,
    Planner,
    PlanResult,
    plan,
    score_candidate,
)

__all__ = [
    "SLO",
    "Candidate",
    "CandidateScore",
    "PlanResult",
    "Planner",
    "PolicySpec",
    "TwinRuntimeFactory",
    "fitted",
    "plan",
    "score_candidate",
]
