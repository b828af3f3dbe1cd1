"""Bayesian logistic regression.

Counterpart of ``brancher_tpu/models/logistic_regression.py``: the same
data generator (numpy, so both packages see identical data for a seed)
and the same model, whole or minibatched (``batch_size``: x and y load
through one ``RandomIndices`` draw and the likelihood scales by N/B).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import functions as BF
from ..standard_variables import (
    BernoulliVariable,
    EmpiricalVariable,
    NormalVariable,
    RandomIndices,
)
from ..variables import ProbabilisticModel


def make_logreg_data(
    num_points: int = 1000, dim: int = 32, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    w_true = rng.normal(0, 1, size=dim).astype(np.float32) / np.sqrt(dim)
    x = rng.normal(0, 1, size=(num_points, dim)).astype(np.float32)
    logits = x @ w_true
    y = (rng.uniform(size=num_points) < 1.0 / (1.0 + np.exp(-logits))).astype(np.int32)
    return x, y, w_true


def logistic_regression_model(
    x: np.ndarray,
    y: np.ndarray,
    prior_scale: float = 1.0,
    batch_size: Optional[int] = None,
):
    """w ~ N(0, prior_scale I); y_i ~ Bernoulli(sigmoid(x_i.w)).

    With ``batch_size``: the reference's RandomIndices/EmpiricalVariable
    minibatch pattern — x and y are loaded through the same index draw,
    and the likelihood is rescaled by N/B.
    """
    n, d = x.shape
    w = NormalVariable(torch.zeros(d), prior_scale * torch.ones(d), "w")
    xt = torch.as_tensor(np.asarray(x, np.float32))
    if batch_size is None:
        yv = BernoulliVariable(logits=BF.matmul(xt, w), name="y")
        yv.observe(np.asarray(y))
        return ProbabilisticModel([yv])

    idx = RandomIndices(n, batch_size, "idx")
    xb = EmpiricalVariable(xt, name="xb", indices=idx)
    yb = EmpiricalVariable(torch.as_tensor(np.asarray(y)), name="yb", indices=idx)
    yv = BernoulliVariable(logits=BF.matmul(xb, w), name="y",
                           log_prob_scale=float(n) / float(batch_size))
    yv.observe(yb)
    return ProbabilisticModel([yv])
