"""Plain float32 reference of olmoe-1b-7b as the serving executors run it.

The decoder as ``configs/olmoe-1b-7b.json`` states it: RMSNorm (scale
``1 + w``, eps 1e-6), multi-head attention with rotary positions (halves of
the head rotated, base ``rope_theta``), a Gshard mixture of experts in every
layer (float32 router, softmax, the top ``top_k`` by a stable descending
sort, gates renormalised over the chosen, SwiGLU experts; per group of
``moe_group`` tokens each expert takes at most ``capacity`` assignments in
token-major order, and the rest are dropped), a final RMSNorm and an
unembedding of its own.

What an executor serves: one prefill of its prompt, then decode steps of one
token each. The prefill's cache holds as many slots as the prompt has
tokens, and a decode step past it writes its key and value into the last
slot and attends over all of them (the program's clamped cache write, kept
on purpose): decode step ``j`` (from 1) of a prompt of T tokens sees the
prompt's keys 0..T-2 and its own key, at position T - 1 + j. So every
decode step depends on the prompt and its own position alone, and all the
asked steps are computed as one batch of positions. After decode step
``j`` the last slot holds that step's key and value in every layer, which
``outputs`` also gives.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from pb_common import load_module

_c = load_module(Path(__file__).with_name("_common.py"))


def specs(p: dict) -> dict:
    d, h, kv, hd = p["d_model"], p["n_heads"], p["n_kv_heads"], p["head_dim"]
    L, E, f, V = p["n_layers"], p["n_experts"], p["d_ff_expert"], p["vocab"]
    return {
        "embed/w": ((V, d), "embed", None),
        "layers/attn/q": ((L, d, h, hd), "normal", None),
        "layers/attn/k": ((L, d, kv, hd), "normal", None),
        "layers/attn/v": ((L, d, kv, hd), "normal", None),
        "layers/attn/o": ((L, h, hd, d), "normal", None),
        "layers/ln_attn/scale": ((L, d), "zeros", None),
        "layers/ln_mlp/scale": ((L, d), "zeros", None),
        "layers/moe/router/w": ((L, d, E), "normal", None),
        "layers/moe/wi_0": ((L, E, d, f), "normal", None),
        "layers/moe/wi_1": ((L, E, d, f), "normal", None),
        "layers/moe/wo": ((L, E, f, d), "normal", None),
        "ln_f/scale": ((d,), "zeros", None),
        "unembed/w": ((d, V), "normal", d ** -0.5),
    }


def served_dtype(p: dict, path: str) -> torch.dtype:
    """Norm scales and the router are served in float32, every other
    parameter in the configuration's ``dtype`` (bf16)."""
    parts = path.split("/")
    if parts[-2].startswith("ln_") or parts[-3:-1] == ["moe", "router"]:
        return torch.float32
    return getattr(torch, p["dtype"])


def capacity(p: dict) -> int:
    c = math.ceil(p["moe_group"] * p["top_k"] / p["n_experts"]
                  * p["capacity_factor"])
    return max(4, int(math.ceil(c / 4) * 4))


def rope(x, pos, theta: float):
    """x (N, H, D) at integer positions ``pos`` (N,)."""
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                          device=x.device) / D))
    ang = pos.double()[:, None] * freqs
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def moe(p, W, l, h, group: int, pr):
    """The expert layer ``l`` over rows ``h`` (N, d), in groups of
    ``group`` consecutive rows."""
    E, K = p["n_experts"], p["top_k"]
    C = capacity(p)
    probs = torch.softmax(h.float() @ W["layers/moe/router/w"][l].float(), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :K], idx[:, :K]
    gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    chosen = idx.cpu().tolist()
    keep = [[True] * K for _ in chosen]
    for g0 in range(0, len(chosen), group):
        taken = [0] * E
        for t in range(g0, min(g0 + group, len(chosen))):
            for k, e in enumerate(chosen[t]):
                keep[t][k] = taken[e] < C
                taken[e] += 1
    keep = torch.tensor(keep, dtype=torch.bool, device=h.device)
    y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e in torch.unique(idx[keep]).tolist():
        rows, ks = torch.nonzero((idx == e) & keep, as_tuple=True)
        x = h[rows]
        a = pr.mm(x, W["layers/moe/wi_0"][l, e])
        b = pr.mm(x, W["layers/moe/wi_1"][l, e])
        out = pr.mm(torch.nn.functional.silu(a) * b, W["layers/moe/wo"][l, e])
        y.index_add_(0, rows, out * gates[rows, ks][:, None])
    return y


def attend(q, k, v, mask):
    """q (N, H, D), k/v (M, Hkv, D) or (N, M, Hkv, D), mask (N, M)."""
    H, Hkv = q.shape[1], k.shape[-2]
    k = k.repeat_interleave(H // Hkv, dim=-2)
    v = v.repeat_interleave(H // Hkv, dim=-2)
    eq = "nhd,mhd->nhm" if k.dim() == 3 else "nhd,nmhd->nhm"
    s = torch.einsum(eq, q, k) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    a = torch.softmax(s, -1)
    eq = "nhm,mhd->nhd" if v.dim() == 3 else "nhm,nmhd->nhd"
    return torch.einsum(eq, a, v)


def outputs(p: dict, seed: int, prompt, token: int, steps, device,
            precision: str = "float32") -> dict:
    """What an executor of ``seed`` serves after ``s`` decode steps, for
    every ``s`` in ``steps`` (0: the prefill's): ``logits`` {s: (V,)
    float32} and ``kv`` {s: (layers, 2, kv heads, head dim) float32, the
    K and V in the cache's last slot}."""
    _c.no_tf32()
    pr = _c.Prec(precision)
    W = _c.draw(specs(p), seed, device,
                lambda path: served_dtype(p, path))
    d, H, Hkv, D = p["d_model"], p["n_heads"], p["n_kv_heads"], p["head_dim"]
    T = len(prompt)
    P = max(max(steps), 1)
    tok = torch.as_tensor(list(prompt), device=device).long()
    x = pr.store(W["embed/w"][tok].float())
    xd = pr.store(W["embed/w"][torch.full((P,), int(token),
                                          device=device)].float())
    pos = torch.arange(T, device=device)
    pos_d = T + torch.arange(P, device=device)
    causal = pos[:, None] >= pos[None, :]
    seen = torch.ones((P, T), dtype=torch.bool, device=device)
    # the last slot after s steps: the prompt's last key (s = 0) or step s's
    at = torch.as_tensor([T - 1 + s for s in steps], device=device)
    last = []

    def qkv(l, h, at):
        h = pr.act(h)
        q = (h @ pr.weight(W["layers/attn/q"][l].reshape(d, H * D)))
        k = (h @ pr.weight(W["layers/attn/k"][l].reshape(d, Hkv * D)))
        v = (h @ pr.weight(W["layers/attn/v"][l].reshape(d, Hkv * D)))
        q, k, v = (t.unflatten(-1, (-1, D)) for t in (q, k, v))
        th = p["rope_theta"]
        return pr.act(rope(q, at, th)), pr.act(rope(k, at, th)), pr.act(v)

    def out(l, a):
        return pr.mm(a.reshape(a.shape[0], H * D),
                     W["layers/attn/o"][l].reshape(H * D, d))

    for l in range(p["n_layers"]):
        h = rms_norm(x, W["layers/ln_attn/scale"][l])
        q, k, v = qkv(l, h, pos)
        x = pr.store(x + out(l, attend(q, k, v, causal)))
        x = pr.store(x + moe(p, W, l, rms_norm(x, W["layers/ln_mlp/scale"][l]),
                             min(p["moe_group"], T), pr))
        # decode rows: the prompt's keys 0..T-2 and each row's own key
        hd_ = rms_norm(xd, W["layers/ln_attn/scale"][l])
        qd, kd, vd = qkv(l, hd_, pos_d)
        kk = torch.cat([k[None, :T - 1].expand(P, -1, -1, -1), kd[:, None]], 1)
        vv = torch.cat([v[None, :T - 1].expand(P, -1, -1, -1), vd[:, None]], 1)
        last.append(torch.stack([torch.cat([k, kd])[at],
                                 torch.cat([v, vd])[at]], 1))
        xd = pr.store(xd + out(l, attend(qd, kk, vv, seen)))
        xd = pr.store(xd + moe(p, W, l, rms_norm(xd,
                                                 W["layers/ln_mlp/scale"][l]),
                               1, pr))
    un = W["unembed/w"]
    lg_p = pr.mm(rms_norm(x[-1:], W["ln_f/scale"]), un)[0]
    lg_d = pr.mm(rms_norm(xd, W["ln_f/scale"]), un)
    del W
    kv = torch.stack(last, 1).float().cpu()  # (steps, layers, 2, Hkv, D)
    return {"logits": {s: (lg_p if s == 0 else lg_d[s - 1]).float().cpu()
                       for s in steps},
            "kv": {s: kv[i] for i, s in enumerate(steps)}}


rms_norm = _c.rms_norm
