"""The literal SSD oracle: the recurrence, step by step (port of the JAX
package's ``kernels/ssd_scan/ref.py``)."""

from __future__ import annotations

import torch


def ssd_ref(x, dt, A, B, C):
    """The literal recurrence in float32, in the model's layout: x (b, S, nh,
    hd); dt (b, S, nh); A (nh,); B/C (b, S, ds). Per step
    ``h = h * exp(dt A) + (dt x) (x) B`` and ``y = h . C``. Returns (y (b, S,
    nh, hd) in x's dtype, final state (b, nh, hd, ds) float32)."""
    b, S, nh, hd = x.shape
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    a = A.float()
    h = torch.zeros((b, nh, hd, B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * a)[:, :, None, None]
        upd = (dtf[:, t][:, :, None] * xf[:, t])[..., None] \
            * Bf[:, t][:, None, None, :]
        h = h * decay + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h
