"""Open-loop Poisson arrivals (the program's ``PoissonWorkload``, redrawn
with stratified blocks): a steady rate on the stream's own clock, lognormal
output lengths.

Parameters (a cell's ``traffic``): ``rate_per_s``; ``tokens``: ``median``,
``sigma``, ``min``, ``max``; ``bytes_per_token``; ``block`` (tasks per
stratified block).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pb_common import load_module

_strata = load_module(Path(__file__).with_name("_strata.py"))


def stream(p: dict, seed: int):
    """Yields (arrival_ms, tokens, payload_bytes) forever."""
    rng = np.random.default_rng(seed)
    tok = p["tokens"]
    block = int(p.get("block", 256))
    sizes = _strata.lognormal_tokens(rng, tok["median"], tok["sigma"],
                                     tok["min"], tok["max"], block)
    gaps = _strata.exponential(rng, 1000.0 / p["rate_per_s"], block)
    t = 0.0
    for n, gap in zip(sizes, gaps):
        t += gap
        yield t, n, n * float(p["bytes_per_token"])
