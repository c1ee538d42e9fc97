"""Fitted models carried across as plain numpy arrays.

``fitted_models_to_arrays`` flattens a ``FittedModels`` into a dict of numpy
arrays and floats; ``fitted_models_from_arrays`` rebuilds the port's models
from such a dict. Any object with the same attributes exports the same way,
so models fitted elsewhere (the JAX package's ``repro.core.fit``) predict
from identical parameters in the port.

Keys: ``upld.theta`` and ``comp_edge.theta`` (ridge); ``<m>.mean``,
``<m>.std``, ``<m>.quantum`` for the normal models ``start_warm``,
``start_cold``, ``store_cloud``, ``iotup``, ``store_edge``;
``comp_cloud.features``/``.thresholds``/``.leaves``/``.base`` and
``comp_cloud.config`` = ``[n_trees, max_depth, learning_rate, n_bins,
min_samples_leaf, min_gain]`` (GBRT); and the floats
``cloud_comp_std_frac``, ``edge_comp_std_frac``, ``cloud_e2e_mape``,
``edge_e2e_mape``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.fit import FittedModels
from repro_torch.core.gbrt import GBRT, GBRTConfig
from repro_torch.core.perf_models import NormalModel, RidgeModel

RIDGE = ("upld", "comp_edge")
NORMAL = ("start_warm", "start_cold", "store_cloud", "iotup", "store_edge")
SCALARS = ("cloud_comp_std_frac", "edge_comp_std_frac", "cloud_e2e_mape",
           "edge_e2e_mape")


def fitted_models_to_arrays(models) -> dict[str, np.ndarray | float]:
    """Flatten fitted models (attributes as ``FittedModels``) to arrays."""
    out: dict[str, np.ndarray | float] = {}
    for name in RIDGE:
        out[f"{name}.theta"] = np.array(getattr(models, name).theta,
                                        np.float64)
    for name in NORMAL:
        m = getattr(models, name)
        for attr in ("mean", "std", "quantum"):
            out[f"{name}.{attr}"] = float(getattr(m, attr))
    g = models.comp_cloud
    out["comp_cloud.features"] = np.array(g.features, np.int32)
    out["comp_cloud.thresholds"] = np.array(g.thresholds, np.float64)
    out["comp_cloud.leaves"] = np.array(g.leaves, np.float64)
    out["comp_cloud.base"] = float(g.base)
    c = g.config
    out["comp_cloud.config"] = np.array(
        [c.n_trees, c.max_depth, c.learning_rate, c.n_bins,
         c.min_samples_leaf, c.min_gain], np.float64)
    for name in SCALARS:
        out[name] = float(getattr(models, name))
    return out


def fitted_models_from_arrays(arrays: dict) -> FittedModels:
    """Rebuild the port's ``FittedModels`` from ``fitted_models_to_arrays``
    output; every parameter is copied, bit for bit."""
    kw = {}
    for name in RIDGE:
        kw[name] = RidgeModel(theta=np.array(arrays[f"{name}.theta"],
                                             np.float64))
    for name in NORMAL:
        kw[name] = NormalModel(mean=float(arrays[f"{name}.mean"]),
                               std=float(arrays[f"{name}.std"]),
                               quantum=float(arrays[f"{name}.quantum"]))
    cfg = np.asarray(arrays["comp_cloud.config"], np.float64)
    config = GBRTConfig(n_trees=int(cfg[0]), max_depth=int(cfg[1]),
                        learning_rate=float(cfg[2]), n_bins=int(cfg[3]),
                        min_samples_leaf=int(cfg[4]), min_gain=float(cfg[5]))
    kw["comp_cloud"] = GBRT(
        config=config, base=float(arrays["comp_cloud.base"]),
        features=np.array(arrays["comp_cloud.features"], np.int32),
        thresholds=np.array(arrays["comp_cloud.thresholds"], np.float64),
        leaves=np.array(arrays["comp_cloud.leaves"], np.float64))
    for name in SCALARS:
        kw[name] = float(arrays[name])
    return FittedModels(**kw)
