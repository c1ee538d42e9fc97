"""The comparison that decides ``correct``.

Every number compared has a limit of its own (``PERF.md`` gives the
readings each was set from); a run is correct when every one is within it:

- ``unserved``: tasks of the window that failed, were shed or came back
  without a record (limit 0);
- ``placement_mismatch``: tasks, warm-up and window, whose target or
  predicted cold start differs from the plain numpy MinLatency over the
  same calibrated catalog (``reference/placement.py``; limit 0);
- ``prediction_rel_err``: the largest relative gap of a predicted latency,
  cost or allowed cost to the reference's (limit 1e-9: the decision engine
  may sum in another order);
- ``record_rel_err``: the largest relative gap, over the window's tasks, of
  a record's latency to the sum of its execution's feed, start, comp, store
  and queue times, and of its cost to the slice price of its comp time,
  recomputed here (limit 1e-9); an execution missing for a record, or one
  too many, fails it;
- ``logit_err``: the served logits of every window execution of a sample
  of executors (drawn from the seed, always with the executor that ran the
  most decode steps) against the plain float32 reference of the model with
  the executor's weights, drawn again from its seed
  (``reference/<config>.py``): the largest logit error over the
  reference's root mean square logit, the largest over the executions
  compared (the limit in the cell's ``check.limits``);
- ``kv_err``, for a model with a K/V cache: every layer's key and value in
  the cache's last slot after each of those executions (the dense family's
  decode steps write each step's there) against the reference's at the
  same position: the largest error over the reference's root mean square
  key (or value) of that layer, the largest over the executions (the limit
  in ``check.limits``). It is what a decode step that leaves the cache
  unchanged breaks, which moves the logits less than bf16 rounding does;
- ``executions_compared``: at least one.
"""

from __future__ import annotations

import math
import time

import numpy as np

import pb_common as pc

REL = 1e-9


def catalog_numbers(cat, rt, specs) -> dict:
    """The calibrated catalog as plain numbers (the decision engine's
    input, which the numpy reference places from)."""
    g = cat.comp_cloud
    return {
        "clouds": [{"name": s.name, "chips": s.chips} for s in specs],
        "edge": rt.edge_names[0],
        "gbrt": {"base": g.base, "learning_rate": g.config.learning_rate,
                 "depth": g.config.max_depth,
                 "features": np.asarray(g.features),
                 "thresholds": np.asarray(g.thresholds),
                 "leaves": np.asarray(g.leaves)},
        "feed_theta": [float(v) for v in cat.feed.theta],
        "edge_theta": [float(v) for v in cat.comp_edge.theta],
        "start_warm": cat.start_warm.mean, "start_cold": cat.start_cold.mean,
        "store": cat.store.mean, "store_edge": cat.store_edge.mean,
        "price": {"chip_hour_rate": cat.pricing.chip_hour_rate,
                  "quantum_s": cat.pricing.quantum_s},
    }


def _rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def placements(catalog: dict, wl: dict, all_tasks, rows) -> dict:
    from_ref = pc.load_module(pc.HERE / "reference" / "placement.py")
    pol = wl["serve"]["policy"]
    ref = from_ref.place({**catalog, "c_max": pol["c_max"],
                          "alpha": pol["alpha"],
                          "t_idl_ms": wl["serve"]["t_idl_ms"]}, all_tasks)
    bad = sum(a != b for a, b in zip(ref["target"], rows["target"]))
    bad += int(np.count_nonzero(np.asarray(ref["cold"])
                                != rows["predicted_cold"]))
    err = max(_rel(rows["predicted_ms"], ref["latency_ms"]),
              _rel(rows["predicted_cost"], ref["cost"]),
              _rel(rows["allowed"], ref["allowed"]))
    return {"mismatch": int(bad), "rel_err": err}


def record_arithmetic(rows, execs, specs: dict, price: dict) -> float:
    """Largest relative gap of the records to their executions; inf when
    the executions do not pair one for one with the records."""
    from_ref = pc.load_module(pc.HERE / "reference" / "placement.py")
    by_target: dict[str, list] = {}
    for e in execs:
        by_target.setdefault(e.target, []).append(e)
    worst = 0.0
    used = {t: 0 for t in by_target}
    for i, tgt in enumerate(rows["target"]):
        lst = by_target.get(tgt, [])
        j = used.get(tgt, 0)
        if j >= len(lst):
            return math.inf
        used[tgt] = j + 1
        r = lst[j].record
        total = r.feed_ms + r.start_ms + r.comp_ms + r.store_ms + r.queue_ms
        worst = max(worst, _rel(rows["latency_ms"][i], total))
        if tgt in specs:
            cost = from_ref.slice_cost(r.comp_ms, specs[tgt], price)
            worst = max(worst, _rel(rows["cost"][i], cost))
            if bool(rows["cold"][i]) != bool(r.cold):
                return math.inf
        elif rows["cost"][i] != 0.0:
            return math.inf
    if any(used[t] != len(by_target[t]) for t in by_target):
        return math.inf
    return worst


def sample_executors(execs, seed: int, n: int) -> list[int]:
    """Up to ``n`` executor seeds, drawn from ``seed``; the one that ran
    the most decode steps always among them."""
    seeds = sorted({e.seed for e in execs if e.logits is not None})
    if not seeds:
        return []
    longest = max((e for e in execs if e.logits is not None),
                  key=lambda e: e.steps).seed
    rest = [s for s in seeds if s != longest]
    rng = np.random.default_rng(seed)
    pick = list(rng.permutation(rest)[:max(n - 1, 0)]) if rest else []
    return [longest] + [int(s) for s in pick]


def readings(cfg: dict, config_name: str, execs, inputs, chosen, device,
             control: str | None = None, log=pc.log) -> dict:
    """The comparison of each chosen executor's executions with the float32
    reference: under ``served`` the program's outputs, and under
    ``control`` (a precision of ``Prec``) the reference computed in that
    precision, put in the program's place at the same executions. Each
    holds ``logit_err`` and ``top_gap`` per execution, and ``kv_err`` where
    the model has a K/V cache."""
    import torch

    ref = pc.reference_module(config_name)
    _c = pc.load_module(pc.HERE / "reference" / "_common.py")
    sides = ["served"] + ([control] if control else [])
    out = {side: {"top_gap": [], "logit_err": [], "kv_err": []}
           for side in sides}
    n = 0
    for s in chosen:
        mine = [e for e in execs if e.seed == s and e.logits is not None]
        steps = sorted({e.steps for e in mine})
        prompt, token = inputs[s]
        t0 = time.perf_counter()
        want = ref.outputs(cfg, s, prompt, token, steps, device)
        got = {"served": {"logits": {i: e.logits for i, e in enumerate(mine)},
                          "kv": {i: e.kv for i, e in enumerate(mine)}}}
        if control:
            ctl = ref.outputs(cfg, s, prompt, token, steps, device, control)
            got[control] = {k: {i: v[e.steps] for i, e in enumerate(mine)}
                            for k, v in ctl.items()}
        for side in sides:
            r = _c.compare(
                torch.stack([got[side]["logits"][i] for i in range(len(mine))]),
                torch.stack([want["logits"][e.steps] for e in mine]))
            for k in r:
                out[side][k] += list(r[k])
            kv = got[side].get("kv", {})
            if "kv" in want and all(kv.get(i) is not None
                                    for i in range(len(mine))):
                out[side]["kv_err"] += list(_c.compare_kv(
                    torch.stack([kv[i].float() for i in range(len(mine))]),
                    torch.stack([want["kv"][e.steps] for e in mine])))
        n += len(mine)
        log(f"[perfbench] reference of executor {s}: {len(mine)} executions, "
            f"up to {max(steps)} decode steps, {time.perf_counter() - t0:.2f} s")
        if device == "cuda":
            torch.cuda.empty_cache()
    out["n"] = n
    return out


def check(*, prog, config_name, wl, seed, catalog, all_tasks, prog_rows,
          window_rows, execs, inputs, device, control=None,
          log=pc.log) -> tuple[dict, dict]:
    """Every number compared, with its limit and whether it holds, and the
    readings of the outputs compared. With ``control`` the reference in that
    precision stands in the program's outputs' place, so a sound control
    comes out not correct."""
    lim = wl["check"]["limits"]
    out = {}
    unserved = int(window_rows["failed"].sum())
    out["unserved"] = {"value": unserved, "limit": 0, "ok": unserved == 0}
    pl = placements(catalog, wl, all_tasks, prog_rows)
    out["placement_mismatch"] = {"value": pl["mismatch"], "limit": 0,
                                 "ok": pl["mismatch"] == 0}
    out["prediction_rel_err"] = {"value": pl["rel_err"], "limit": REL,
                                 "ok": pl["rel_err"] <= REL}
    specs = {c["name"]: c["chips"] for c in catalog["clouds"]}
    rec = record_arithmetic(window_rows, execs, specs, catalog["price"])
    out["record_rel_err"] = {"value": rec, "limit": REL, "ok": rec <= REL}
    chosen = sample_executors(execs, seed, wl["check"]["sample_executors"])
    rd = readings(prog, config_name, execs, inputs, chosen, device, control,
                  log=log)
    compared = rd[control or "served"]
    for name in ("logit_err", "kv_err"):
        if name in lim:
            v = float(max(compared[name], default=math.inf))
            out[name] = {"value": v, "limit": lim[name], "ok": v <= lim[name]}
    out["executions_compared"] = {"value": rd["n"], "limit": 1,
                                  "ok": rd["n"] >= 1}
    return out, rd
