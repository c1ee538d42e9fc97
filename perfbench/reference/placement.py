"""Plain numpy MinLatency placement over a calibrated slice catalog: the
reference the decision engine's placements and predictions are held to.

One task at a time, in arrival order, as the paper's Algorithm 1 reads:

- every cloud config's predicted latency is feed + start + comp + store,
  with the cold start's mean when no container of that config is idle and
  unexpired in the client-side container list, the warm start's mean
  otherwise; comp is the gradient-boosted trees' sum over (tokens, chips);
  its cost bills the predicted comp time in whole seconds of its chips;
- the edge's predicted latency is its predicted queue wait plus comp and
  store, at no cost;
- the policy takes, among the targets whose cost is within c_max + alpha
  times the banked surplus, the one of least latency (then cost; the first
  in catalog order on a tie), banks c_max minus its cost, and records the
  dispatch: a cloud config reuses its idle container of latest completion
  or adds one, busy until feed + start + comp after the arrival; the edge
  queue's horizon moves on by the predicted comp time.

The catalog comes in as plain numbers (``catalog``); nothing of the program
is imported.
"""

from __future__ import annotations

import math

import numpy as np


def gbrt_predict(g: dict, x: np.ndarray) -> np.ndarray:
    """Sum of ``g``'s trees over rows ``x`` (n, features): heap-ordered
    complete trees, a row goes right where its feature exceeds the
    threshold."""
    depth = int(g["depth"])
    out = np.full(x.shape[0], float(g["base"]))
    rows = np.arange(x.shape[0])
    for f, th, lv in zip(g["features"], g["thresholds"], g["leaves"]):
        node = np.zeros(x.shape[0], np.int64)
        for _ in range(depth):
            node = 2 * node + 1 + (x[rows, f[node]] > th[node])
        out += float(g["learning_rate"]) * lv[node - (2 ** depth - 1)]
    return out


def slice_cost(comp_ms: float, chips: int, price: dict) -> float:
    q = float(price["quantum_s"])
    seconds = math.ceil(max(comp_ms, 1.0) / 1000.0 / q) * q
    return seconds * chips * float(price["chip_hour_rate"]) / 3600.0


def place(catalog: dict, tasks: list[tuple[float, float, float]]) -> dict:
    """Place ``tasks`` ((arrival_ms, tokens, payload_bytes), in arrival
    order). Returns per task the target's name, predicted latency, cost,
    cold flag and the allowed cost in force."""
    clouds = catalog["clouds"]
    edge = catalog["edge"]
    c_max, alpha = float(catalog["c_max"]), float(catalog["alpha"])
    t_idl = float(catalog["t_idl_ms"])
    arr = np.array([t[0] for t in tasks], dtype=np.float64)
    size = np.array([t[1] for t in tasks], dtype=np.float64)
    nbytes = np.array([t[2] for t in tasks], dtype=np.float64)
    feed_t, edge_t = catalog["feed_theta"], catalog["edge_theta"]
    upld = np.maximum(feed_t[0] + nbytes * feed_t[1], 0.0)
    store = max(float(catalog["store"]), 0.0)
    warm_s = max(float(catalog["start_warm"]), 0.0)
    cold_s = max(float(catalog["start_cold"]), 0.0)
    comp = {c["name"]: np.maximum(gbrt_predict(
        catalog["gbrt"], np.stack([size, np.full_like(size, c["chips"])],
                                  axis=1)), 0.0) for c in clouds}
    edge_comp = np.maximum(edge_t[0] + size * edge_t[1], 0.0)
    edge_store = max(float(catalog["store_edge"]), 0.0)

    containers = {c["name"]: [] for c in clouds}  # [busy_until, last_done]
    horizon = 0.0
    surplus = 0.0
    out = {"target": [], "latency_ms": [], "cost": [], "cold": [],
           "allowed": []}
    for i in range(len(tasks)):
        now = arr[i]
        for name, lst in containers.items():
            containers[name] = [c for c in lst
                                if now < c[0] or now <= c[1] + t_idl]
        cands = []
        for c in clouds:
            name = c["name"]
            idle = [k for k in containers[name]
                    if not now < k[0] and now <= k[1] + t_idl]
            cold = not idle
            start = cold_s if cold else warm_s
            lat = upld[i] + start + comp[name][i] + store
            cost = slice_cost(comp[name][i], c["chips"], catalog["price"])
            cands.append((name, lat, cost, cold, upld[i] + start
                          + comp[name][i]))
        wait = max(horizon - now, 0.0)
        cands.append((edge, wait + (edge_comp[i] + 0.0 + edge_store), 0.0,
                      False, None))
        allowed = c_max + alpha * surplus
        feasible = [c for c in cands if c[2] <= allowed]
        best = min(feasible, key=lambda c: (c[1], c[2]))
        name, lat, cost, cold, occupancy = best
        surplus += c_max - cost
        if name == edge:
            horizon = max(horizon, now) + edge_comp[i]
        else:
            done = now + occupancy
            idle = [k for k in containers[name]
                    if not now < k[0] and now <= k[1] + t_idl]
            if idle:
                k = max(idle, key=lambda k: k[1])
                k[0] = k[1] = done
            else:
                containers[name].append([done, done])
        out["target"].append(name)
        out["latency_ms"].append(lat)
        out["cost"].append(cost)
        out["cold"].append(cold)
        out["allowed"].append(allowed)
    return out
