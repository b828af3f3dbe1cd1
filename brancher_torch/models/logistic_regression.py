"""Bayesian logistic regression.

Counterpart of ``brancher_tpu/models/logistic_regression.py``: the same
data generator (numpy, so both packages see identical data for a seed)
and the same model.  The minibatch form (``batch_size``) needs the
data-loader variables, which are still to port (ROADMAP queue 1,
item 14).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import functions as BF
from ..standard_variables import BernoulliVariable, NormalVariable
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
    """w ~ N(0, prior_scale I); y_i ~ Bernoulli(sigmoid(x_i.w))."""
    if batch_size is not None:
        raise NotImplementedError(
            "minibatched logistic regression needs RandomIndices and "
            "EmpiricalVariable (ROADMAP queue 1, item 14)"
        )
    d = x.shape[1]
    w = NormalVariable(torch.zeros(d), prior_scale * torch.ones(d), "w")
    logits = BF.matmul(torch.as_tensor(np.asarray(x, np.float32)), w)
    yv = BernoulliVariable(logits=logits, name="y")
    yv.observe(np.asarray(y))
    return ProbabilisticModel([yv])
