"""Stratified draws shared by the traffic generators.

A generator takes its task sizes, arrival gaps and phase lengths in blocks:
each block holds the distribution's quantiles at evenly spaced levels, put
in an order drawn from the seed. Every seed thus sends the same set of sizes
and gaps over each block, in another order, so runs with different seeds
differ by the order of the work and not by how much of it there is.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

_NORMAL = NormalDist()


def levels(block: int) -> np.ndarray:
    return (np.arange(block, dtype=np.float64) + 0.5) / block


def lognormal_tokens(rng: np.random.Generator, median: float, sigma: float,
                     lo: int, hi: int, block: int):
    """Integer token counts, lognormal (``median``, ``sigma``) clipped to
    [``lo``, ``hi``], forever."""
    z = np.array([_NORMAL.inv_cdf(u) for u in levels(block)])
    base = np.clip(np.rint(np.exp(math.log(median) + sigma * z)), lo, hi)
    while True:
        yield from (int(v) for v in rng.permutation(base))


def exponential(rng: np.random.Generator, mean: float, block: int):
    """Exponential draws of mean ``mean``, forever."""
    base = -np.log1p(-levels(block)) * mean
    while True:
        yield from (float(v) for v in rng.permutation(base))
