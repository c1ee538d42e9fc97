"""Model training & evaluation (paper Sec. IV-C): fit the component models from
collected measurements, 80:20 split, and build a ready-to-use Predictor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.apps import AWSTwin, Measurements, MEMORY_CONFIGS_MB, collect_measurements
from repro_torch.core.cil import ContainerInfoList, DEFAULT_T_IDL_MS
from repro_torch.core.gbrt import GBRT, GBRTConfig
from repro_torch.core.perf_models import NormalModel, RidgeModel, mape
from repro_torch.core.predictor import EdgeFleet, EdgeTarget, LambdaTarget, Predictor
from repro_torch.core.pricing import LambdaPricing


@dataclass
class FittedModels:
    upld: RidgeModel
    comp_cloud: GBRT
    start_warm: NormalModel
    start_cold: NormalModel
    store_cloud: NormalModel
    comp_edge: RidgeModel
    iotup: NormalModel
    store_edge: NormalModel
    cloud_comp_std_frac: float
    edge_comp_std_frac: float
    # Table II evaluation on held-out test split:
    cloud_e2e_mape: float = float("nan")
    edge_e2e_mape: float = float("nan")


def split_indices(n: int, frac: float = 0.8, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    cut = int(n * frac)
    return perm[:cut], perm[cut:]


def fit_models(
    meas: Measurements,
    gbrt_config: GBRTConfig | None = None,
    seed: int = 0,
) -> FittedModels:
    """Fit every component model on an 80% split; evaluate end-to-end MAPE on 20%."""
    gbrt_config = gbrt_config or GBRTConfig(n_trees=150, max_depth=3, learning_rate=0.1)

    n_cloud = meas.sizes.shape[0]
    tr, te = split_indices(n_cloud, 0.8, seed)

    upld = RidgeModel.fit(meas.nbytes[tr], meas.upld[tr])
    x_comp = np.stack([meas.sizes, meas.memory], axis=1)
    comp_cloud = GBRT.fit(x_comp[tr], meas.comp[tr], gbrt_config)
    start_warm = NormalModel.fit(meas.start_warm)
    start_cold = NormalModel.fit(meas.start_cold)
    store_cloud = NormalModel.fit(meas.store[tr], quantum=0.0)

    comp_pred_tr = comp_cloud.predict(x_comp[tr])
    cloud_std_frac = float(np.std((meas.comp[tr] - comp_pred_tr) / np.maximum(comp_pred_tr, 1e-9)))

    n_edge = meas.edge_sizes.shape[0]
    etr, ete = split_indices(n_edge, 0.8, seed + 1)
    comp_edge = RidgeModel.fit(meas.edge_sizes[etr], meas.edge_comp[etr])
    iotup = NormalModel.fit(meas.iotup[etr])
    store_edge = NormalModel.fit(meas.edge_store[etr])
    edge_pred_tr = comp_edge.predict(meas.edge_sizes[etr])
    edge_std_frac = float(np.std((meas.edge_comp[etr] - edge_pred_tr) / np.maximum(edge_pred_tr, 1e-9)))

    # ---- Table II: end-to-end MAPE on the held-out test split (warm start) ----
    cloud_pred = (
        upld.predict(meas.nbytes[te])
        + start_warm.predict()
        + comp_cloud.predict(x_comp[te])
        + store_cloud.predict()
    )
    # Actual end-to-end for the same rows, with a fresh warm-start draw per row
    rng = np.random.default_rng(seed + 2)
    cloud_actual = (
        meas.upld[te]
        + np.maximum(rng.normal(start_warm.mean, start_warm.std, te.shape[0]), 1.0)
        + meas.comp[te]
        + meas.store[te]
    )
    cloud_e2e_mape = mape(cloud_pred, cloud_actual)

    edge_pred = comp_edge.predict(meas.edge_sizes[ete]) + iotup.predict() + store_edge.predict()
    edge_actual = meas.edge_comp[ete] + meas.iotup[ete] + meas.edge_store[ete]
    edge_e2e_mape = mape(edge_pred, edge_actual)

    return FittedModels(
        upld=upld, comp_cloud=comp_cloud, start_warm=start_warm, start_cold=start_cold,
        store_cloud=store_cloud, comp_edge=comp_edge, iotup=iotup, store_edge=store_edge,
        cloud_comp_std_frac=cloud_std_frac, edge_comp_std_frac=edge_std_frac,
        cloud_e2e_mape=cloud_e2e_mape, edge_e2e_mape=edge_e2e_mape,
    )


def build_predictor(
    models: FittedModels,
    configs: tuple[int, ...] = MEMORY_CONFIGS_MB,
    pricing: LambdaPricing | None = None,
    t_idl_ms: float = DEFAULT_T_IDL_MS,
    quantile: float | None = None,
) -> Predictor:
    pricing = pricing or LambdaPricing()
    cloud_targets = [
        LambdaTarget(
            name=str(m), memory_mb=float(m),
            upld_model=models.upld,
            start_warm=models.start_warm, start_cold=models.start_cold,
            comp_model=models.comp_cloud, store_model=models.store_cloud,
            pricing=pricing, comp_std_frac=models.cloud_comp_std_frac,
        )
        for m in configs
    ]
    edge_target = EdgeTarget(
        comp_model=models.comp_edge, iotup_model=models.iotup,
        store_model=models.store_edge, comp_std_frac=models.edge_comp_std_frac,
    )
    return Predictor(
        cloud_targets=cloud_targets, edge_target=edge_target,
        cil=ContainerInfoList(t_idl_ms=t_idl_ms), quantile=quantile,
    )


def build_fleet_predictor(
    models: FittedModels,
    edge_devices: int | dict[str, float],
    configs: tuple[int, ...] = MEMORY_CONFIGS_MB,
    pricing: LambdaPricing | None = None,
    t_idl_ms: float = DEFAULT_T_IDL_MS,
    quantile: float | None = None,
    prefix: str = "edge",
) -> Predictor:
    """``build_predictor`` over a multi-device edge fleet.

    ``edge_devices`` is either a device count (homogeneous fleet named
    ``{prefix}0..{prefix}{n-1}``) or a mapping ``name -> relative speed``
    (arbitrary device names; a device at speed ``s`` predicts ``comp/s``).
    The matching twin is ``TwinBackend(..., edge_names=..., edge_speed=...)``.
    """
    base = build_predictor(models, configs=configs, pricing=pricing,
                           t_idl_ms=t_idl_ms, quantile=quantile)
    template = base.edge_target
    if isinstance(edge_devices, int):
        fleet = EdgeFleet.replicate(template, edge_devices, prefix=prefix)
    else:
        fleet = EdgeFleet.from_speeds(template, edge_devices)
    return Predictor(cloud_targets=base.cloud_targets, edge_fleet=fleet,
                     cil=ContainerInfoList(t_idl_ms=t_idl_ms), quantile=quantile)


def fit_app(app_name: str, seed: int = 0, n_inputs: int | None = None,
            configs: tuple[int, ...] = MEMORY_CONFIGS_MB) -> tuple[AWSTwin, FittedModels]:
    """Convenience: twin + measurements + fitted models for one paper app."""
    from repro_torch.core.apps import APPS

    twin = AWSTwin(spec=APPS[app_name], seed=seed)
    meas = collect_measurements(twin, n_inputs=n_inputs, configs=configs, seed=seed + 1)
    models = fit_models(meas, seed=seed + 2)
    return twin, models
