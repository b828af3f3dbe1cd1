"""Normal-Normal conjugate mean inference.

Counterpart of ``brancher_tpu/models/conjugate.py``: same data (numpy
seed) and the same closed-form posterior.
"""
from __future__ import annotations

import numpy as np

from ..standard_variables import NormalVariable
from ..variables import ProbabilisticModel


def conjugate_normal_model(
    num_obs: int = 20,
    prior_scale: float = 2.0,
    lik_scale: float = 1.0,
    true_mean: float = 1.5,
    seed: int = 0,
):
    """Returns (model, dict with closed-form posterior mean/var)."""
    rng = np.random.RandomState(seed)
    data = rng.normal(true_mean, lik_scale, size=num_obs).astype(np.float32)
    prior_var, lik_var = prior_scale**2, lik_scale**2
    post_var = 1.0 / (1.0 / prior_var + num_obs / lik_var)
    post_mean = post_var * (np.sum(data) / lik_var)

    mu = NormalVariable(0.0, prior_scale, "mu")
    x = NormalVariable(mu, lik_scale, "x")
    x.observe(data)
    model = ProbabilisticModel([x])
    return model, {"post_mean": post_mean, "post_var": post_var, "data": data}
