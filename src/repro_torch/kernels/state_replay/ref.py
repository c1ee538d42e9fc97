"""Scalar oracle for the state-replay kernel, in the style of the numpy
decision core's walks: Python floats and lists, one row at a time."""

from __future__ import annotations

import numpy as np


def state_replay_ref(nows, guess, *, ecomp=None, h0=None, nom_fixed=None,
                     lpw=False, edge_col=-1, occw=None, occc=None, busy0=None,
                     last0=None, cnt0=None, t_idl: float = 0.0) -> dict:
    """Numpy arrays in, numpy arrays out (keys as ``ReplayOut``)."""
    nows = np.asarray(nows, np.float64)
    guess = np.asarray(guess)
    R = nows.shape[0]
    nd = 0 if ecomp is None else np.asarray(ecomp).shape[1]
    nc = 0 if busy0 is None else np.asarray(busy0).shape[0]
    out = {"hb": np.zeros((R, nd)), "nom": np.zeros(R, np.int64),
           "h_fin": np.zeros(nd), "cold": np.zeros((R, nc), bool)}
    if nd:
        h = [float(v) for v in h0]
        for r in range(R):
            now = float(nows[r])
            waits = [max(hv - now, 0.0) for hv in h]
            d = (waits.index(min(waits)) if lpw else int(nom_fixed[r]))
            out["hb"][r] = h
            out["nom"][r] = d
            if guess[r] == edge_col:
                h[d] = max(h[d], now) + float(ecomp[r][d])
        out["h_fin"] = np.array(h)
    cap = 0 if busy0 is None else np.asarray(busy0).shape[1]
    pools = []
    overflow = np.zeros(nc, np.int64)
    for c in range(nc):
        k = int(cnt0[c])
        pools.append(([float(v) for v in busy0[c][:k]],
                      [float(v) for v in last0[c][:k]]))
    for r in range(R):
        now = float(nows[r])
        for c, (busy, last) in enumerate(pools):
            idle = [i for i in range(len(busy))
                    if busy[i] <= now <= last[i] + t_idl]
            out["cold"][r, c] = not idle
            if guess[r] != c:
                continue
            if not idle:
                if len(busy) >= cap:
                    overflow[c] = 1
                    continue
                completion = now + float(occc[r][c])
                busy.append(completion)
                last.append(completion)
            else:
                best = idle[0]
                for i in idle:           # strict > keeps the first maximum
                    if last[i] > last[best]:
                        best = i
                completion = now + float(occw[r][c])
                busy[best] = completion
                last[best] = completion
    out["busy"] = np.full((nc, cap), np.inf)
    out["last"] = np.full((nc, cap), -np.inf)
    for c, (busy, last) in enumerate(pools):
        out["busy"][c, :len(busy)] = busy
        out["last"][c, :len(last)] = last
    out["cnt"] = np.array([len(b) for b, _ in pools], np.int64)
    out["overflow"] = overflow
    return out
