"""AR(p) time series under NUTS: BASELINE config 3.

Counterpart of ``brancher_tpu/models/autoregressive.py``: the same data
generator (numpy, so both packages see identical data for a seed), the
same priors (coefficients ~ N(0, 0.5), noise scale ~ LogNormal(-1, 0.5))
and the AR(1) stationary moments.  The observed series is recognized as
the normal_learned GLM family over its lag matrix (``ops.glm``), so
``sample()`` runs it on K3 / K4 on the card.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..standard_variables import LogNormalVariable, NormalVariable
from ..stochastic_processes import ARProcess
from ..variables import ProbabilisticModel


def make_ar_data(length: int = 500, coeffs: Sequence[float] = (0.7,), noise: float = 0.3,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    p = len(coeffs)
    x = list(rng.normal(0, 1, size=p))
    for _ in range(length - p):
        mean = sum(c * x[-1 - i] for i, c in enumerate(coeffs))
        x.append(mean + rng.normal(0, noise))
    return np.asarray(x, dtype=np.float32)


def ar_model(data: np.ndarray, order: int = 1) -> ProbabilisticModel:
    """Priors: coeffs ~ N(0, 0.5) [order]; noise_scale ~ LogNormal(-1, 0.5)."""
    coeffs = NormalVariable(np.zeros(order, np.float32), 0.5 * np.ones(order, np.float32),
                            "coeffs")
    noise = LogNormalVariable(-1.0, 0.5, "noise_scale")
    series = ARProcess(len(data), coeffs, noise, name="series", order=order,
                       init_loc=0.0, init_scale=1.0)
    series.observe(data)
    return ProbabilisticModel([series])


def ar1_stationary_stats(c: float, noise: float) -> Tuple[float, float]:
    """Closed-form stationary mean and variance of AR(1)."""
    return 0.0, noise**2 / (1.0 - c**2)
