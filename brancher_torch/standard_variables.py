"""User-facing variable constructors.

Counterpart of ``brancher_tpu/standard_variables.py``.  Constructors keep
the reference's positional style, e.g. ``NormalVariable(mu, sigma, "x")``,
and accept numbers, arrays, tensors, variables or expressions in every
parameter position.

One constructor per distribution of ``distributions.py``, with
``NonCenteredNormalVariable``, the data loaders ``EmpiricalVariable`` and
``RandomIndices``, and ``MixtureVariable`` (a marginalised finite
mixture).
"""
from __future__ import annotations

import numpy as np

from . import distributions as D
from .variables import DeterministicVariable, PartialLink, RandomVariable, Variable

__all__ = [
    "NormalVariable", "LogNormalVariable", "HalfNormalVariable",
    "CauchyVariable", "HalfCauchyVariable", "LaplaceVariable",
    "LogisticVariable", "StudentTVariable", "UniformVariable", "TruncatedNormalVariable",
    "GammaVariable", "InverseGammaVariable", "ExponentialVariable",
    "Chi2Variable", "BetaVariable", "BernoulliVariable", "BinomialVariable",
    "PoissonVariable", "GeometricVariable", "CategoricalVariable",
    "ConcreteVariable", "MultivariateNormalVariable", "DirichletVariable", "MixtureVariable",
    "DeterministicVariable", "EmpiricalVariable", "RandomIndices",
    "NonCenteredNormalVariable",
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


def HalfNormalVariable(scale, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.HalfNormal(), {"scale": scale}, name, plate_shape, log_prob_scale, observed)


def CauchyVariable(loc, scale, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Cauchy(), {"loc": loc, "scale": scale}, name, plate_shape, log_prob_scale, observed)


def HalfCauchyVariable(scale, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.HalfCauchy(), {"scale": scale}, name, plate_shape, log_prob_scale, observed)


def LaplaceVariable(loc, scale, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Laplace(), {"loc": loc, "scale": scale}, name, plate_shape, log_prob_scale, observed)


def LogisticVariable(loc, scale, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Logistic(), {"loc": loc, "scale": scale}, name, plate_shape, log_prob_scale, observed)


def StudentTVariable(df, loc, scale, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.StudentT(), {"df": df, "loc": loc, "scale": scale}, name, plate_shape,
               log_prob_scale, observed)


def TruncatedNormalVariable(loc, scale, low, high, name=None, plate_shape=(), log_prob_scale=1.0,
                            observed=None):
    return _rv(D.TruncatedNormal(), {"loc": loc, "scale": scale, "low": low, "high": high},
               name, plate_shape, log_prob_scale, observed)


def UniformVariable(low, high, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Uniform(), {"low": low, "high": high}, name, plate_shape, log_prob_scale, observed)


def GammaVariable(concentration, rate, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Gamma(), {"concentration": concentration, "rate": rate}, name, plate_shape,
               log_prob_scale, observed)


def InverseGammaVariable(concentration, scale, name=None, plate_shape=(), log_prob_scale=1.0,
                         observed=None):
    return _rv(D.InverseGamma(), {"concentration": concentration, "scale": scale}, name,
               plate_shape, log_prob_scale, observed)


def ExponentialVariable(rate, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Exponential(), {"rate": rate}, name, plate_shape, log_prob_scale, observed)


def Chi2Variable(df, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Chi2(), {"df": df}, name, plate_shape, log_prob_scale, observed)


def BetaVariable(alpha, beta, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Beta(), {"alpha": alpha, "beta": beta}, name, plate_shape, log_prob_scale, observed)


def BernoulliVariable(probs=None, name=None, logits=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Bernoulli(), {"probs": probs, "logits": logits}, name, plate_shape, log_prob_scale, observed)


def BinomialVariable(total_count, probs=None, name=None, logits=None, plate_shape=(),
                     log_prob_scale=1.0, observed=None):
    return _rv(D.Binomial(), {"total_count": total_count, "probs": probs, "logits": logits},
               name, plate_shape, log_prob_scale, observed)


def PoissonVariable(rate, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Poisson(), {"rate": rate}, name, plate_shape, log_prob_scale, observed)


def GeometricVariable(probs=None, name=None, logits=None, plate_shape=(), log_prob_scale=1.0,
                      observed=None):
    return _rv(D.Geometric(), {"probs": probs, "logits": logits}, name, plate_shape,
               log_prob_scale, observed)


def CategoricalVariable(probs=None, name=None, logits=None, plate_shape=(), log_prob_scale=1.0,
                        observed=None):
    return _rv(D.Categorical(), {"probs": probs, "logits": logits}, name, plate_shape,
               log_prob_scale, observed)


def ConcreteVariable(temperature, logits, name=None, plate_shape=(), log_prob_scale=1.0,
                     observed=None):
    return _rv(D.Concrete(), {"temperature": temperature, "logits": logits}, name, plate_shape,
               log_prob_scale, observed)


def MultivariateNormalVariable(loc, name=None, covariance_matrix=None, scale_tril=None,
                               plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.MultivariateNormal(),
               {"loc": loc, "covariance_matrix": covariance_matrix, "scale_tril": scale_tril},
               name, plate_shape, log_prob_scale, observed)


def DirichletVariable(concentration, name=None, plate_shape=(), log_prob_scale=1.0, observed=None):
    return _rv(D.Dirichlet(), {"concentration": concentration}, name, plate_shape,
               log_prob_scale, observed)


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


def MixtureVariable(component_dist, probs=None, name=None, logits=None, plate_shape=(),
                    log_prob_scale=1.0, observed=None, **component_params):
    """Marginalised finite mixture (no discrete assignment latent, so it
    works under HMC/NUTS).  Component parameters carry a leading K axis::

        x = MixtureVariable(D.Normal(), probs=[0.3, 0.7], loc=mus, scale=sigs, name="x")
    """
    links = {"probs": probs, "logits": logits, **component_params}
    return _rv(D.Mixture(component_dist), links, name, plate_shape, log_prob_scale, observed)
