"""Pricing models for execution cost.

The paper uses the AWS Lambda pricing model: billed duration is the function
execution time rounded up to the nearest 100 ms, priced proportionally to the
container memory. The paper's text quotes ``$1.667e-6 per GB-s`` but the C_max
values in Tables IV/V are only consistent with the actual AWS rate of
``$1.66667e-5 per GB-s`` (e.g. FD at 1536 MB with ~1.2 s billed ≈ 2.9e-5 $ ≈
the paper's C_max = 2.97e-5). We therefore use the real AWS rate and note the
paper's typo in DESIGN.md.

Edge executions are free under the paper's amortization argument (fixed yearly
Greengrass registration fee, zero marginal cost per execution).

For the TPU-fleet adaptation, ``SlicePricing`` bills slice-seconds at a
$/chip-hour rate with a per-second billing quantum.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# Real AWS Lambda rate (the paper's table values are consistent with this, not
# with the 1.667e-6 typo in the text).
AWS_GB_SECOND_RATE = 1.66667e-5
AWS_REQUEST_RATE = 0.20 / 1_000_000  # $0.20 per 1M requests
AWS_BILLING_QUANTUM_MS = 100.0


@dataclass(frozen=True)
class LambdaPricing:
    """AWS Lambda execution pricing (the paper's cost model)."""

    gb_second_rate: float = AWS_GB_SECOND_RATE
    request_rate: float = AWS_REQUEST_RATE
    quantum_ms: float = AWS_BILLING_QUANTUM_MS
    include_request_charge: bool = False  # paper studies execution cost only

    def billed_ms(self, comp_ms: float) -> float:
        """Round execution time to nearest ms, then up to the billing quantum."""
        ms = round(float(comp_ms))
        if ms <= 0:
            ms = 1
        return math.ceil(ms / self.quantum_ms) * self.quantum_ms

    def cost(self, comp_ms: float, memory_mb: float) -> float:
        """Execution cost in $ for ``comp_ms`` of compute in an ``memory_mb`` container."""
        gb = memory_mb / 1024.0
        c = (self.billed_ms(comp_ms) / 1000.0) * gb * self.gb_second_rate
        if self.include_request_charge:
            c += self.request_rate
        return c

    def billed_ms_batch(self, comp_ms: np.ndarray) -> np.ndarray:
        """Vectorized ``billed_ms`` (np.round matches round(): half-to-even)."""
        ms = np.maximum(np.round(np.asarray(comp_ms, dtype=np.float64)), 1.0)
        return np.ceil(ms / self.quantum_ms) * self.quantum_ms

    def cost_batch(self, comp_ms: np.ndarray, memory_mb: float) -> np.ndarray:
        """Vectorized ``cost`` over an array of compute times."""
        gb = memory_mb / 1024.0
        c = (self.billed_ms_batch(comp_ms) / 1000.0) * gb * self.gb_second_rate
        if self.include_request_charge:
            c = c + self.request_rate
        return c


@dataclass(frozen=True)
class EdgePricing:
    """Edge executions have zero amortized marginal cost (paper Sec. II-A.2b)."""

    def cost(self, comp_ms: float) -> float:  # noqa: ARG002 - interface parity
        return 0.0

    def cost_batch(self, comp_ms: np.ndarray) -> np.ndarray:
        return np.zeros(np.asarray(comp_ms).shape[0], dtype=np.float64)


@dataclass(frozen=True)
class SlicePricing:
    """TPU-fleet adaptation: $/chip-hour, billed per second, per slice dispatch.

    ``chips`` is the slice size; billing covers the task's occupancy of the
    slice (comp time only — provisioning is amortized like the paper amortizes
    container lifetime).
    """

    chip_hour_rate: float = 1.20  # $/chip-hour (v5e on-demand ballpark)
    quantum_s: float = 1.0

    def cost(self, comp_ms: float, chips: int) -> float:
        seconds = math.ceil(max(comp_ms, 1.0) / 1000.0 / self.quantum_s) * self.quantum_s
        return seconds * chips * self.chip_hour_rate / 3600.0

    def cost_batch(self, comp_ms: np.ndarray, chips: int) -> np.ndarray:
        ms = np.maximum(np.asarray(comp_ms, dtype=np.float64), 1.0)
        seconds = np.ceil(ms / 1000.0 / self.quantum_s) * self.quantum_s
        return seconds * chips * self.chip_hour_rate / 3600.0
