"""Component performance models (paper Sec. IV).

The paper models each latency component separately:

- upload / edge-compute: (ridge) linear regression on input size,
- warm/cold startup, storage, IoT-upload: normal random variables, predicted by
  the training-set mean (storage is additionally quantized by S3's 1 s
  timestamp granularity, which only affects measurement, not the model form),
- cloud compute: gradient-boosted regression trees (see ``repro_torch.core.gbrt``).

These are small models fit on CPU with closed-form or histogram methods; the
prediction paths are vectorizable and also exposed through torch (and, for the
serving hot path, through a CUDA kernel — ``repro_torch.kernels.gbrt_predict``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def fit_ridge(x: np.ndarray, y: np.ndarray, l2: float = 1e-6) -> np.ndarray:
    """Closed-form ridge regression with bias: returns theta for [1, x...] features.

    ``x``: (n,) or (n, d) features, ``y``: (n,) targets.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    X = np.concatenate([np.ones((n, 1)), x], axis=1)
    d = X.shape[1]
    reg = l2 * np.eye(d)
    reg[0, 0] = 0.0  # don't penalize the bias
    theta = np.linalg.solve(X.T @ X + reg, X.T @ y)
    return theta


@dataclass
class RidgeModel:
    """Linear model ``y = theta_0 + theta_1 * x_1 + ...`` (paper: upld(k), edge comp(k))."""

    theta: np.ndarray = field(default_factory=lambda: np.zeros(2))

    @classmethod
    def fit(cls, x: np.ndarray, y: np.ndarray, l2: float = 1e-6) -> "RidgeModel":
        return cls(theta=fit_ridge(x, y, l2=l2))

    def predict(self, x) -> np.ndarray:
        """Elementwise affine map — deliberately NOT a BLAS matmul.

        ``X @ theta`` routes through gemv, whose reduction order (FMA,
        blocking) may depend on the batch size, so the same row could predict
        differently in a 1-row and a 10k-row batch — a last-ULP wobble that
        would break the streaming serve's bit-parity across chunk sizes.
        A fixed left-fold of elementwise ops gives the identical float for
        every element at every batch size.
        """
        x = np.asarray(x, dtype=np.float64)
        scalar = x.ndim == 0
        if x.ndim <= 1:
            x = np.atleast_1d(x)[:, None]
        out = self.theta[0] + x[:, 0] * self.theta[1]
        for j in range(1, x.shape[1]):
            out = out + x[:, j] * self.theta[j + 1]
        return float(out[0]) if scalar else out

    def mape(self, x: np.ndarray, y: np.ndarray) -> float:
        pred = self.predict(x)
        y = np.asarray(y, dtype=np.float64)
        return float(np.mean(np.abs(pred - y) / np.maximum(np.abs(y), 1e-9))) * 100.0


@dataclass
class NormalModel:
    """Normal-random-variable component model, predicted by its mean.

    Used for start_w(m)/start_c(m), store(k), iotup(k). ``quantum`` reproduces
    the S3 coarse-timestamp quantization the paper observed (measurement-side).
    Quantile prediction (``predict_quantile``) powers the beyond-paper
    variance-aware placement policy.
    """

    mean: float = 0.0
    std: float = 0.0
    quantum: float = 0.0

    @classmethod
    def fit(cls, samples: np.ndarray, quantum: float = 0.0) -> "NormalModel":
        s = np.asarray(samples, dtype=np.float64)
        if quantum > 0:
            s = np.round(s / quantum) * quantum
        return cls(mean=float(np.mean(s)), std=float(np.std(s)), quantum=quantum)

    def predict(self) -> float:
        return self.mean

    def predict_quantile(self, q: float) -> float:
        """Mean + z_q * std via Acklam's inverse-normal approximation (no scipy)."""
        return self.mean + _norm_ppf(q) * self.std

    def sample(self, rng: np.random.Generator, n: int | None = None):
        out = rng.normal(self.mean, self.std, size=n)
        return np.maximum(out, 0.0)


def _norm_ppf(q: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation, |err| < 1.15e-9)."""
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0,1), got {q}")
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    if q < plow:
        ql = np.sqrt(-2 * np.log(q))
        return (((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]) / \
               ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1)
    if q > phigh:
        ql = np.sqrt(-2 * np.log(1 - q))
        return -(((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]) / \
                ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1)
    ql = q - 0.5
    r = ql * ql
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * ql / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def mape(pred: np.ndarray, actual: np.ndarray) -> float:
    """Mean absolute percentage error (paper Table II metric)."""
    pred = np.asarray(pred, dtype=np.float64)
    actual = np.asarray(actual, dtype=np.float64)
    return float(np.mean(np.abs(pred - actual) / np.maximum(np.abs(actual), 1e-9))) * 100.0


@dataclass(frozen=True)
class ScaledModel:
    """A component model whose predictions are multiplied by a constant factor.

    Heterogeneous edge fleets reuse one fitted compute model per device class:
    a device running at relative speed ``s`` predicts ``base.predict(x) / s``
    (``scale = 1/s``). Works for scalars and arrays, so both the per-task and
    the batched prediction paths stay in parity.
    """

    base: object
    scale: float = 1.0

    def predict(self, x):
        out = self.base.predict(x)
        if np.ndim(out) == 0:
            return float(out) * self.scale
        return np.asarray(out) * self.scale
