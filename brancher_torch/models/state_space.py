"""Linear-Gaussian state-space model: BASELINE config 4.

Counterpart of ``brancher_tpu/models/state_space.py`` (lines 24-89): the
same simulator (numpy), the DSL view of the model (a ``MarkovProcess``
latent chain with Gaussian emissions) for NUTS and SVI, the explicit
``StateSpace`` for the particle methods (batched callbacks, see
``inference/smc.py``), and the exact Kalman filter, the particle
methods' yardstick.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..distributions import Normal
from ..inference.smc import StateSpace
from ..standard_variables import NormalVariable
from ..stochastic_processes import MarkovProcess
from ..variables import ProbabilisticModel


class LGSSMParams(NamedTuple):
    a: float = 0.9  # transition coefficient
    q: float = 0.3  # transition variance
    c: float = 1.0  # emission coefficient
    r: float = 0.5  # emission variance
    init_var: float = 1.0


def make_lgssm_data(length: int = 100, params: LGSSMParams = LGSSMParams(), seed: int = 0):
    rng = np.random.RandomState(seed)
    xs = [rng.normal(0, np.sqrt(params.init_var))]
    for _ in range(length - 1):
        xs.append(params.a * xs[-1] + rng.normal(0, np.sqrt(params.q)))
    xs = np.asarray(xs, np.float32)
    ys = (params.c * xs + rng.normal(0, np.sqrt(params.r), size=length)).astype(np.float32)
    return xs, ys


def lgssm_model(ys: np.ndarray, params: LGSSMParams = LGSSMParams()) -> ProbabilisticModel:
    """DSL view: latent Markov chain and elementwise Gaussian emissions."""
    x = MarkovProcess(
        len(ys), Normal(),
        lambda prev: {"loc": params.a * prev, "scale": float(np.sqrt(params.q))},
        init_dist=Normal(), init_links={"loc": 0.0, "scale": float(np.sqrt(params.init_var))},
        name="x",
    )
    y = NormalVariable(params.c * x, float(np.sqrt(params.r)), "y")
    y.observe(ys)
    return ProbabilisticModel([y])


def _normal_log_prob(v, m, var):
    return -0.5 * (v - m) ** 2 / var - 0.5 * math.log(2 * math.pi * var)


def lgssm_state_space(params: LGSSMParams = LGSSMParams()) -> StateSpace:
    """The LGSSM as a StateSpace whose draws land on the generator's device."""
    a, q, c, r, v0 = params

    def randn(generator, shape):
        return torch.randn(tuple(shape), generator=generator, device=generator.device)

    return StateSpace(
        init_sample=lambda g, shape: math.sqrt(v0) * randn(g, shape),
        init_log_prob=lambda x: _normal_log_prob(x, 0.0, v0),
        trans_sample=lambda g, x, t: a * x + math.sqrt(q) * randn(g, x.shape),
        trans_log_prob=lambda x, xp, t: _normal_log_prob(x, a * xp, q),
        obs_log_prob=lambda y, x, t: _normal_log_prob(y, c * x, r),
    )


def kalman_filter(ys: np.ndarray, params: LGSSMParams = LGSSMParams()):
    """Exact filter in float64 numpy: (log_marginal, filter_means, filter_vars)."""
    a, q, c, r, v0 = params
    mean, var = 0.0, v0
    ll = 0.0
    means, vars_ = [], []
    for t, y in enumerate(np.asarray(ys, np.float64)):
        if t > 0:
            mean, var = a * mean, a * a * var + q
        s = c * c * var + r
        ll += -0.5 * (y - c * mean) ** 2 / s - 0.5 * np.log(2 * np.pi * s)
        k = var * c / s
        mean = mean + k * (y - c * mean)
        var = (1.0 - k * c) * var
        means.append(mean)
        vars_.append(var)
    return ll, np.asarray(means), np.asarray(vars_)
