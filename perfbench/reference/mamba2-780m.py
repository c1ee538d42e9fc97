"""Plain float32 reference of mamba2-780m as the serving executors run it.

The Mamba-2 LM as ``configs/mamba2-780m.json`` states it (arXiv:2405.21060):
per layer RMSNorm (scale ``1 + w``, eps 1e-6), an input projection to
[z, x, B, C, dt], a depthwise causal convolution of width ``conv_width``
over [x, B, C] with its bias, SiLU, the selective state space with a scalar
A = -exp(a_log) per head and dt = softplus(dt + dt_bias),

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,    y_t = h_t C_t + D x_t,

a gated RMSNorm (``rms(y) (1 + w) silu(z)``) and an output projection; a
final RMSNorm and an unembedding of its own.

What an executor serves: one prefill of its prompt, then decode steps of one
token each, carrying the state. That is one causal pass over the prompt and
the fed tokens, which this reference makes at once: the state space in
chunks, exactly (the decays within a chunk as exponentials of differences
of cumulative sums, the state carried between chunks), in float32.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.nn.functional as F

from pb_common import load_module

_c = load_module(Path(__file__).with_name("_common.py"))

CHUNK = 64
FLOAT32 = {("ln", "scale"), ("ln_f", "scale"), ("norm", "scale"),
           ("mixer", "a_log"), ("mixer", "dt_bias")}


def dims(p: dict):
    di = p["ssm_expand"] * p["d_model"]
    return di, di // p["ssm_head_dim"], p["ssm_head_dim"], p["ssm_state"]


def specs(p: dict) -> dict:
    d, L, V, W = p["d_model"], p["n_layers"], p["vocab"], p["conv_width"]
    di, nh, hd, ds = dims(p)
    cd = di + 2 * ds
    return {
        "embed/w": ((V, d), "embed", None),
        "layers/ln/scale": ((L, d), "zeros", None),
        "layers/mixer/in_proj": ((L, d, 2 * di + 2 * ds + nh), "normal",
                                 None),
        "layers/mixer/conv/w": ((L, W, cd), "normal", None),
        "layers/mixer/conv/b": ((L, cd), "zeros", None),
        "layers/mixer/a_log": ((L, nh), "ones", None),
        "layers/mixer/d_skip": ((L, nh), "ones", None),
        "layers/mixer/dt_bias": ((L, nh), "zeros", None),
        "layers/mixer/norm/scale": ((L, di), "zeros", None),
        "layers/mixer/out_proj": ((L, di, d), "normal", None),
        "ln_f/scale": ((d,), "zeros", None),
        "unembed/w": ((d, V), "normal", d ** -0.5),
    }


def served_dtype(p: dict, path: str) -> torch.dtype:
    """The norm scales, ``a_log`` and ``dt_bias`` are served in float32,
    every other parameter in the configuration's ``dtype`` (bf16)."""
    if tuple(path.split("/")[-2:]) in FLOAT32:
        return torch.float32
    return getattr(torch, p["dtype"])


def ssd(x, dt, A, B, C):
    """x (S, nh, hd), dt (S, nh), A (nh,), B/C (S, ds) -> y (S, nh, hd)."""
    S, nh, hd = x.shape
    h = torch.zeros((nh, hd, B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, S, CHUNK):
        xs, dts = x[c0:c0 + CHUNK], dt[c0:c0 + CHUNK]
        Bs, Cs = B[c0:c0 + CHUNK], C[c0:c0 + CHUNK]
        q = xs.shape[0]
        cum = torch.cumsum(dts * A, 0)                       # (q, nh)
        seg = cum[:, None, :] - cum[None, :, :]              # (t, s, nh)
        live = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~live[:, :, None], float("-inf")))
        w = (Cs @ Bs.T)[:, :, None] * decay * dts[None, :, :]
        y = torch.einsum("tsh,shp->thp", w, xs)
        y = y + torch.einsum("tn,hpn->thp", Cs, h) * torch.exp(cum)[:, :, None]
        last = cum[-1]
        carry = torch.exp(last[None, :] - cum) * dts          # (q, nh)
        h = h * torch.exp(last)[:, None, None] \
            + torch.einsum("sh,shp,sn->hpn", carry, xs, Bs)
        ys.append(y)
    return torch.cat(ys)


def outputs(p: dict, seed: int, prompt, token: int, steps, device,
            precision: str = "float32") -> dict:
    """What an executor of ``seed`` serves after ``s`` decode steps, for
    every ``s`` in ``steps`` (0: the prefill's): ``logits`` {s: (V,)
    float32}."""
    _c.no_tf32()
    pr = _c.Prec(precision)
    W = _c.draw(specs(p), seed, device,
                lambda path: served_dtype(p, path))
    di, nh, hd, ds = dims(p)
    T = len(prompt)
    ids = list(prompt) + [int(token)] * max(steps)
    x = pr.store(W["embed/w"][torch.as_tensor(ids, device=device).long()])
    S = x.shape[0]
    K = p["conv_width"]
    for l in range(p["n_layers"]):
        g = lambda name: W[f"layers/mixer/{name}"][l]  # noqa: E731
        h = _c.rms_norm(x, W["layers/ln/scale"][l])
        zx = pr.mm(h, g("in_proj"))
        z, xbc, dt = zx[:, :di], zx[:, di:2 * di + 2 * ds], zx[:, 2 * di + 2 * ds:]
        pad = F.pad(xbc, (0, 0, K - 1, 0))
        w = g("conv/w").float()
        conv = sum(pad[i:i + S] * w[i] for i in range(K)) + g("conv/b").float()
        conv = pr.store(F.silu(conv))
        xs = conv[:, :di].reshape(S, nh, hd)
        Bs, Cs = conv[:, di:di + ds], conv[:, di + ds:]
        A = -torch.exp(g("a_log").float())
        dt = torch.logaddexp(dt + g("dt_bias").float(), torch.zeros(()).to(x))
        y = ssd(xs, dt, A, Bs, Cs) + xs * g("d_skip").float()[None, :, None]
        y = _c.rms_norm(y.reshape(S, di), g("norm/scale")) * F.silu(z)
        x = pr.store(x + pr.mm(y, g("out_proj")))
    rows = torch.as_tensor([T - 1 + s for s in steps], device=device)
    lg = pr.mm(_c.rms_norm(x[rows], W["ln_f/scale"]), W["unembed/w"])
    del W
    return {"logits": {s: lg[i].float().cpu() for i, s in enumerate(steps)}}
