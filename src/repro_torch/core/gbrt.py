"""Gradient Boosted Regression Trees, from scratch (paper Sec. IV-A compute model).

scikit-learn is not available in this environment, so we implement least-squares
gradient boosting with depth-limited regression trees ourselves:

- trees are complete binary trees in heap layout (root 0, children 2i+1/2i+2),
  which makes prediction a fixed-depth, fully-vectorizable index walk — the
  same representation the CUDA serving kernels (``repro_torch.kernels.gbrt_predict``)
  consume directly;
- splits are found with histogram scans over per-feature quantile bins;
- nodes that cannot improve SSE become pass-through (threshold=+inf ⇒ all
  samples go left) so every tree keeps the complete-tree shape.

``GBRT.predict`` is numpy (fast scalar calls for the event simulator);
``GBRT.predict_torch`` is the same walk on torch tensors (any device), the
plain counterpart of the CUDA ensemble kernels in
``repro_torch.kernels.gbrt_predict``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

@dataclass(frozen=True)
class GBRTConfig:
    n_trees: int = 150
    max_depth: int = 3
    learning_rate: float = 0.1
    n_bins: int = 64
    min_samples_leaf: int = 4
    min_gain: float = 1e-12


@dataclass
class GBRT:
    config: GBRTConfig
    base: float = 0.0
    # Stacked tree arrays: (T, n_internal) and (T, n_leaves)
    features: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.int32))
    thresholds: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float64))
    leaves: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float64))

    # ------------------------------------------------------------------ fit
    @classmethod
    def fit(cls, x: np.ndarray, y: np.ndarray, config: GBRTConfig | None = None) -> "GBRT":
        config = config or GBRTConfig()
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        n, d = x.shape
        depth = config.max_depth
        n_internal = 2**depth - 1
        n_leaves = 2**depth

        # Per-feature quantile bin edges (candidate thresholds).
        edges = []
        for j in range(d):
            qs = np.quantile(x[:, j], np.linspace(0, 1, config.n_bins + 1)[1:-1])
            edges.append(np.unique(qs))

        base = float(np.mean(y))
        pred = np.full(n, base)
        feats = np.zeros((config.n_trees, n_internal), np.int32)
        thrs = np.full((config.n_trees, n_internal), np.inf)
        lvs = np.zeros((config.n_trees, n_leaves), np.float64)

        for t in range(config.n_trees):
            resid = y - pred
            f_t, th_t, lv_t = _fit_tree(x, resid, edges, config)
            feats[t], thrs[t], lvs[t] = f_t, th_t, lv_t
            pred += config.learning_rate * _predict_tree(x, f_t, th_t, lv_t, depth)
        return cls(config=config, base=base, features=feats, thresholds=thrs, leaves=lvs)

    # -------------------------------------------------------------- predict
    def predict(self, x) -> np.ndarray:
        """Vectorized numpy prediction; accepts (n,d), (d,), or scalar (d=1)."""
        x = np.asarray(x, dtype=np.float64)
        scalar = x.ndim == 0
        if x.ndim == 0:
            x = x[None, None]
        elif x.ndim == 1:
            # Ambiguity: 1-feature batch vs single multi-feature row. Our models
            # always pass batches of rows, so treat (k,) as k rows of 1 feature
            # when the model has 1 feature, else as one row.
            if self.features.size and self.n_features == 1:
                x = x[:, None]
            else:
                x = x[None, :]
        depth = self.config.max_depth
        out = np.full(x.shape[0], self.base)
        for t in range(self.features.shape[0]):
            out += self.config.learning_rate * _predict_tree(
                x, self.features[t], self.thresholds[t], self.leaves[t], depth
            )
        return float(out[0]) if scalar else out

    def const1_table(self, c: float) -> tuple[np.ndarray, np.ndarray]:
        """The (breaks, values) step table of ``predict_const1`` for feature 1
        fixed at ``c`` — built once per (model, c) and cached on the model.

        Exposed so serving-side caches (``repro_torch.core.predictor``'s
        per-(model, comp_feature) table cache) can hold the table without
        re-deriving it per call. A refit must swap in a FRESH model object
        (never mutate a fitted one): both this cache and the serving cache key
        on the model's identity, so mutation would serve stale tables.
        """
        key = float(c)
        cache = self.__dict__.setdefault("_const1_tables", {})
        tab = cache.get(key)
        if tab is None:
            # segment boundaries: every finite feature-0 threshold. Predicates
            # are ``x > thr`` (right), so values are constant on (b_{i-1}, b_i]
            # and b_i is an exact representative; +inf represents the last
            # open segment (x > every finite threshold).
            mask = (self.features == 0) & np.isfinite(self.thresholds)
            breaks = np.unique(self.thresholds[mask])
            reps = np.concatenate([breaks, [np.inf]])
            pts = np.stack([reps, np.full(reps.shape[0], key)], axis=1)
            tab = (breaks, self.predict(pts))
            cache[key] = tab
        return tab

    def predict_const1(self, x0: np.ndarray, c: float) -> np.ndarray:
        """Fast path for 2-feature models whose feature 1 is fixed at ``c``.

        The serving pipeline evaluates the compute GBRT over (size, memory_mb)
        with ONE memory value per cloud target, so for a fixed ``c`` every
        feature-1 predicate is a constant and the whole ensemble collapses to
        a step function of feature 0. The table is built once per (model, c)
        by running the ordinary tree walk at one representative point per
        threshold segment — predictions are therefore BIT-IDENTICAL to
        ``predict`` (identical leaf paths, identical accumulation order) at a
        searchsorted's cost instead of a 150-tree walk per row.
        """
        breaks, vals = self.const1_table(c)
        return vals[np.searchsorted(breaks, np.asarray(x0, np.float64),
                                    side="left")]

    def predict_torch(self, x):
        """The heap walk on a torch tensor ``x`` of shape (n, d), on its device.

        Same association as ``predict`` (``out += lr * leaf`` per tree, from
        ``base``), so a float64 input gives BIT-IDENTICAL results to the numpy
        walk: every step is one rounded multiply and one rounded add.
        """
        import torch

        dtype = x.dtype
        feats = torch.as_tensor(self.features, dtype=torch.long,
                                device=x.device)
        thrs = torch.as_tensor(self.thresholds, dtype=dtype, device=x.device)
        lvs = torch.as_tensor(self.leaves, dtype=dtype, device=x.device)
        depth = self.config.max_depth
        lr = self.config.learning_rate
        rows = torch.arange(x.shape[0], device=x.device)
        out = torch.full((x.shape[0],), self.base, dtype=dtype,
                         device=x.device)
        for t in range(feats.shape[0]):
            node = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
            for _ in range(depth):
                go_right = x[rows, feats[t][node]] > thrs[t][node]
                node = 2 * node + 1 + go_right.long()
            out = out + lr * lvs[t][node - (2 ** depth - 1)]
        return out

    @property
    def n_features(self) -> int:
        return int(self.features.max()) + 1 if self.features.size else 1

    def mape(self, x: np.ndarray, y: np.ndarray) -> float:
        pred = self.predict(x)
        y = np.asarray(y, dtype=np.float64)
        return float(np.mean(np.abs(pred - y) / np.maximum(np.abs(y), 1e-9))) * 100.0


def _fit_tree(x, resid, edges, config: GBRTConfig):
    """Fit one depth-limited regression tree to residuals. Heap array layout."""
    n, d = x.shape
    depth = config.max_depth
    n_internal = 2**depth - 1
    n_leaves = 2**depth
    feature = np.zeros(n_internal, np.int32)
    threshold = np.full(n_internal, np.inf)  # +inf = pass-through (all left)
    node_value = np.zeros(2**(depth + 1) - 1)  # value at every heap node
    node_value[0] = resid.mean() if n else 0.0

    assign = np.zeros(n, np.int64)  # heap node id per sample
    for level in range(depth):
        level_nodes = range(2**level - 1, 2**(level + 1) - 1)
        new_assign = assign.copy()
        for node in level_nodes:
            mask = assign == node
            cnt = int(mask.sum())
            node_value[2 * node + 1] = node_value[node]
            node_value[2 * node + 2] = node_value[node]
            if cnt < 2 * config.min_samples_leaf:
                continue  # pass-through node
            xs, rs = x[mask], resid[mask]
            best = _best_split(xs, rs, edges, config)
            if best is None:
                continue
            j, thr, left_mean, right_mean = best
            feature[node] = j
            threshold[node] = thr
            go_right = xs[:, j] > thr
            idx = np.nonzero(mask)[0]
            new_assign[idx[~go_right]] = 2 * node + 1
            new_assign[idx[go_right]] = 2 * node + 2
            node_value[2 * node + 1] = left_mean
            node_value[2 * node + 2] = right_mean
        assign = new_assign

    leaves = node_value[n_internal : n_internal + n_leaves].copy()
    return feature, threshold, leaves


def _best_split(xs, rs, edges: Sequence[np.ndarray], config: GBRTConfig):
    """Best (feature, threshold) by SSE reduction via cumulative-sum scan."""
    n = xs.shape[0]
    total_sum = rs.sum()
    best_gain, best = config.min_gain, None
    parent_sse_term = total_sum**2 / n
    for j, ed in enumerate(edges):
        if ed.size == 0:
            continue
        # bucket samples by threshold: side[i, b] = xs[i, j] > ed[b]
        order = np.argsort(xs[:, j], kind="stable")
        xj = xs[order, j]
        rj = rs[order]
        csum = np.cumsum(rj)
        # position of last element <= threshold
        pos = np.searchsorted(xj, ed, side="right")
        valid = (pos >= config.min_samples_leaf) & (n - pos >= config.min_samples_leaf)
        if not valid.any():
            continue
        pos_v = pos[valid]
        left_sum = csum[pos_v - 1]
        right_sum = total_sum - left_sum
        gain = left_sum**2 / pos_v + right_sum**2 / (n - pos_v) - parent_sse_term
        k = int(np.argmax(gain))
        if gain[k] > best_gain:
            best_gain = float(gain[k])
            thr = float(ed[np.nonzero(valid)[0][k]])
            lmean = float(left_sum[k] / pos_v[k])
            rmean = float(right_sum[k] / (n - pos_v[k]))
            best = (j, thr, lmean, rmean)
    return best


def _predict_tree(x, feature, threshold, leaves, depth):
    node = np.zeros(x.shape[0], np.int64)
    for _ in range(depth):
        go_right = x[np.arange(x.shape[0]), feature[node]] > threshold[node]
        node = 2 * node + 1 + go_right.astype(np.int64)
    return leaves[node - (2**depth - 1)]


def grid_search_cv(
    x: np.ndarray,
    y: np.ndarray,
    grid: Sequence[GBRTConfig],
    k: int = 3,
    seed: int = 0,
) -> tuple[GBRTConfig, float]:
    """Paper Sec. IV-C3: grid search with k-fold CV; returns (best config, cv MAPE)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    best_cfg, best_err = None, np.inf
    for cfg in grid:
        errs = []
        for i in range(k):
            test_idx = folds[i]
            train_idx = np.concatenate([folds[j] for j in range(k) if j != i])
            model = GBRT.fit(x[train_idx], y[train_idx], cfg)
            errs.append(model.mape(x[test_idx], y[test_idx]))
        err = float(np.mean(errs))
        if err < best_err:
            best_cfg, best_err = cfg, err
    return best_cfg, best_err
