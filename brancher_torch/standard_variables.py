"""User-facing variable constructors.

Counterpart of ``brancher_tpu/standard_variables.py``.  Constructors keep
the reference's positional style, e.g. ``NormalVariable(mu, sigma, "x")``,
and accept numbers, arrays, tensors, variables or expressions in every
parameter position.

Ported so far: NormalVariable, LogNormalVariable, BernoulliVariable,
NonCenteredNormalVariable and the data loaders EmpiricalVariable and
RandomIndices; the rest of the zoo is ROADMAP queue 1, item 14.
"""
from __future__ import annotations

import numpy as np

from . import distributions as D
from .variables import DeterministicVariable, PartialLink, RandomVariable, Variable

__all__ = [
    "NormalVariable", "LogNormalVariable", "BernoulliVariable",
    "NonCenteredNormalVariable", "DeterministicVariable", "EmpiricalVariable",
    "RandomIndices",
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


def EmpiricalVariable(dataset, name=None, indices=None, batch_size=None):
    """Data-loader node drawing rows of ``dataset``: ``dataset[indices]``
    with ``indices`` (a variable, typically ``RandomIndices``), iid-uniform
    rows with ``batch_size``, the whole dataset with neither."""
    links = {"dataset": dataset}
    if indices is not None:
        links["indices"] = indices
    return RandomVariable(D.Empirical(batch_size=batch_size), name=name, links=links)


def RandomIndices(dataset_size, batch_size, name=None):
    """Minibatch index sampler: ``batch_size`` indices below ``dataset_size``."""
    return RandomVariable(D.RandomIndices(dataset_size, batch_size), name=name, links={})


def NonCenteredNormalVariable(loc, scale, name=None, shape=None, plate_shape=(), raw_name=None):
    """Non-centered Normal: ``raw ~ N(0, 1)`` is the sampled latent and the
    returned deterministic node is ``name = loc + scale * raw``, so that
    HMC/NUTS sample the well-conditioned ``raw`` instead of a funnel when
    ``scale`` is itself random (the ARD and eight-schools geometries).

    ``shape``: event shape of ``raw``.  Inferred by broadcasting the
    concrete ``loc``/``scale`` when omitted; required when both are
    variables or expressions, and when a symbolic operand meets only
    scalar concrete ones (inferring () would share one raw draw across
    every component of the symbolic operand).  The latent is exposed as
    ``.raw`` (named ``raw_name`` or ``f"{name}_raw"``).
    """
    if shape is None:
        symbolic = [isinstance(a, (Variable, PartialLink)) for a in (loc, scale)]
        shapes = [tuple(np.shape(a)) for a, sym in zip((loc, scale), symbolic) if not sym]
        if not shapes:
            raise ValueError(
                "NonCenteredNormalVariable: pass shape= when both loc and "
                "scale are variables/expressions"
            )
        shape = np.broadcast_shapes(*shapes)
        if any(symbolic) and shape == ():
            raise ValueError(
                "NonCenteredNormalVariable: loc/scale includes a variable/"
                "expression whose shape is unknown at model-build time and "
                "the concrete operands are all scalar — pass shape= "
                "explicitly (shape=() if a single shared raw draw is "
                "really intended)"
            )
    shape = tuple(shape)
    raw = NormalVariable(
        np.zeros(shape, np.float32), np.ones(shape, np.float32),
        name=raw_name or (f"{name}_raw" if name else None), plate_shape=plate_shape,
    )
    out = DeterministicVariable(loc + scale * raw, name=name)
    out.raw = raw
    return out
