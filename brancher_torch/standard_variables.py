"""User-facing variable constructors.

Counterpart of ``brancher_tpu/standard_variables.py``.  Constructors keep
the reference's positional style, e.g. ``NormalVariable(mu, sigma, "x")``,
and accept numbers, arrays, tensors, variables or expressions in every
parameter position.

Ported so far: NormalVariable, LogNormalVariable and BernoulliVariable.
NonCenteredNormalVariable comes with the next slice (ROADMAP queue 1,
item 3); the rest of the zoo is item 14.
"""
from __future__ import annotations

from . import distributions as D
from .variables import DeterministicVariable, RandomVariable  # noqa: F401 (re-export)

__all__ = [
    "NormalVariable", "LogNormalVariable", "BernoulliVariable",
    "DeterministicVariable",
]


def _rv(dist, links, name, plate_shape, log_prob_scale, observed=None):
    rv = RandomVariable(
        dist, name=name, links=links, plate_shape=tuple(plate_shape or ()),
        log_prob_scale=log_prob_scale,
    )
    if observed is not None and not isinstance(observed, bool):
        rv.observe(observed)
    return rv


def NormalVariable(loc, scale, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Normal(), {"loc": loc, "scale": scale}, name, plate_shape, log_prob_scale, observed)


def LogNormalVariable(loc, scale, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.LogNormal(), {"loc": loc, "scale": scale}, name, plate_shape, log_prob_scale, observed)


def BernoulliVariable(probs=None, name=None, logits=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Bernoulli(), {"probs": probs, "logits": logits}, name, plate_shape, log_prob_scale, observed)
