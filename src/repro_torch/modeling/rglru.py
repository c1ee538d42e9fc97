"""The depthwise causal temporal convolution of the recurrent blocks.

The port of ``causal_conv1d`` from ``repro.modeling.rglru``, which the
Mamba-2 block (``modeling/ssd.py``) uses in front of its SSD scan. The rest
of that module, the Griffin RG-LRU block, comes with the Griffin slice of
the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(x, w, b):
    """Depthwise causal temporal conv. x: (B, S, D); w: (W, D); b: (D,).
    The taps are summed as the reference sums them: from zeros, tap 0
    first, then the bias."""
    W = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[i]
    return out + b
