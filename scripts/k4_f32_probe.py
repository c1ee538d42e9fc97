#!/usr/bin/env python3
"""A short run of K4 (flash attention) in float32 for the CUDA sanitizer.

The case is the card test's first one, (B, S, H, Hkv, D) = (1, 32, 32, 8,
64) causal, on seeded inputs, launched a few times. Run it from the root of
a checkout on a machine with a card, alone or under the sanitizer:

    python3 scripts/k4_f32_probe.py
    compute-sanitizer --tool racecheck python3 scripts/k4_f32_probe.py
    compute-sanitizer --tool initcheck python3 scripts/k4_f32_probe.py

It prints each launch's largest distance from the CPU plain version and
from a float64 softmax, and whether every launch gave the same bits; it
exits non-zero when they differ.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bhsd,
    flash_attention_plain,
)


def main(launches: int = 3) -> int:
    if not torch.cuda.is_available():
        print("k4_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
               for shape in ((1, 32, 32, 64), (1, 8, 32, 64), (1, 8, 32, 64)))
    dev = torch.device("cuda", 0)
    qc, kc, vc = (t.to(dev) for t in (q, k, v))
    want = flash_attention_plain(q, k, v, causal=True)
    kd = k.double().repeat_interleave(4, 1)
    vd = v.double().repeat_interleave(4, 1)
    s = (q.double() @ kd.transpose(2, 3) / 8.0).masked_fill(
        ~torch.ones(32, 32, dtype=torch.bool).tril(), float("-inf"))
    exact = torch.softmax(s, -1) @ vd
    outs = []
    for i in range(launches):
        got = flash_attention_bhsd(qc, kc, vc, causal=True)
        torch.cuda.synchronize()
        got = got.cpu()
        outs.append(got)
        print(f"launch {i}: vs plain {float((got - want).abs().max()):.3g}, "
              f"vs float64 {float((got.double() - exact).abs().max()):.3g}")
    same = all(torch.equal(o, outs[0]) for o in outs)
    print(f"plain vs float64 {float((want.double() - exact).abs().max()):.3g}; "
          f"all {launches} launches bit-identical: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
