"""Bijections between unconstrained space and distribution supports.

Counterpart of ``brancher_tpu/transforms.py``.  Convention as there:
``forward`` maps unconstrained -> support, ``inverse`` maps support ->
unconstrained, and ``forward_log_det`` returns the ELEMENTWISE
log|d forward / dz| that the caller sums.

Every support of the zoo has its bijection: Identity (real), Exp
(positive), Sigmoid (unit interval), Interval (an affine sigmoid onto
(low, high), bounds read from the distribution's parameters) and
StickBreaking (the simplex).  StickBreaking is the JAX package's
construction, written here: the offset -log(arange(K-1, 0, -1)) makes
z = 0 the uniform point, and the log-det comes already summed over the
event axis.
"""
from __future__ import annotations

import torch

from . import distributions as dists
from .distributions import softplus


class Transform:
    def forward(self, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward_log_det(self, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def unconstrained_shape(self, constrained_shape):
        return tuple(constrained_shape)


class Identity(Transform):
    def forward(self, z):
        return z

    def inverse(self, x):
        return x

    def forward_log_det(self, z):
        return torch.zeros_like(z)


class Exp(Transform):
    """R -> (0, inf)."""

    def forward(self, z):
        return torch.exp(z)

    def inverse(self, x):
        return torch.log(x)

    def forward_log_det(self, z):
        return z


class Sigmoid(Transform):
    """R -> (0, 1)."""

    def forward(self, z):
        return torch.sigmoid(z)

    def inverse(self, x):
        return torch.log(x) - torch.log1p(-x)

    def forward_log_det(self, z):
        return -softplus(z) - softplus(-z)


class Interval(Transform):
    """R -> (low, high) through an affine sigmoid; the bounds are tensors
    read at run time."""

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def forward(self, z):
        return self.low + (self.high - self.low) * torch.sigmoid(z)

    def inverse(self, x):
        u = (x - self.low) / (self.high - self.low)
        return torch.log(u) - torch.log1p(-u)

    def forward_log_det(self, z):
        return torch.log(self.high - self.low) - softplus(z) - softplus(-z)


def _stick_offset(k: int, like: torch.Tensor) -> torch.Tensor:
    return -torch.log(torch.arange(k - 1, 0, -1, dtype=like.dtype, device=like.device))


class StickBreaking(Transform):
    """R^{K-1} -> the interior of the K-simplex (last axis)."""

    @staticmethod
    def _fractions(z):
        v = torch.sigmoid(z + _stick_offset(z.shape[-1] + 1, z))  # stick fractions
        one_minus = torch.cat([torch.ones(z.shape[:-1] + (1,), dtype=z.dtype, device=z.device),
                               torch.cumprod(1 - v, dim=-1)], dim=-1)
        return v, one_minus

    def forward(self, z):
        v, one_minus = self._fractions(z)
        return torch.cat([v * one_minus[..., :-1], one_minus[..., -1:]], dim=-1)

    def inverse(self, x):
        k = x.shape[-1]
        xc = torch.cumsum(x[..., :-1], dim=-1)
        remainder = 1.0 - torch.cat([torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device),
                                     xc[..., :-1]], dim=-1)
        v = x[..., :-1] / remainder
        return torch.log(v) - torch.log1p(-v) - _stick_offset(k, x)

    def forward_log_det(self, z):
        # d x_k / d z_k = v_k (1 - v_k) prod_{j<k} (1 - v_j); summed over the
        # event axis (shape z.shape[:-1])
        v, one_minus = self._fractions(z)
        return torch.sum(torch.log(v) + torch.log1p(-v) + torch.log(one_minus[..., :-1]), dim=-1)

    def unconstrained_shape(self, constrained_shape):
        return tuple(constrained_shape[:-1]) + (constrained_shape[-1] - 1,)


def transform_for(dist: dists.Distribution, params=None) -> Transform:
    """Pick the unconstraining bijection for a distribution's support."""
    s = dist.support
    if s == dists.REAL:
        return Identity()
    if s == dists.POSITIVE:
        return Exp()
    if s == dists.UNIT_INTERVAL:
        return Sigmoid()
    if s == dists.SIMPLEX:
        return StickBreaking()
    if s == dists.INTERVAL:
        if params is None or "low" not in params or "high" not in params:
            raise ValueError("interval support needs low/high parameter values")
        return Interval(params["low"], params["high"])
    raise ValueError(f"no unconstraining transform for support {s!r}")
