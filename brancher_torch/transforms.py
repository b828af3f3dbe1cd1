"""Bijections between unconstrained space and distribution supports.

Counterpart of ``brancher_tpu/transforms.py``.  Convention as there:
``forward`` maps unconstrained -> support, ``inverse`` maps support ->
unconstrained, and ``forward_log_det`` returns the ELEMENTWISE
log|d forward / dz| that the caller sums.

Ported so far: Identity (real support) and Exp (positive support), the
supports of the ported distributions.  Sigmoid, Interval and
StickBreaking are still to port (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import torch

from . import distributions as dists


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


def transform_for(dist: dists.Distribution, params=None) -> Transform:
    """Pick the unconstraining bijection for a distribution's support."""
    s = dist.support
    if s == dists.REAL:
        return Identity()
    if s == dists.POSITIVE:
        return Exp()
    if s in (dists.UNIT_INTERVAL, dists.SIMPLEX, dists.INTERVAL):
        raise NotImplementedError(
            f"the transform for support {s!r} is not ported yet "
            "(ROADMAP queue 1, item 14)"
        )
    raise ValueError(f"no unconstraining transform for support {s!r}")
