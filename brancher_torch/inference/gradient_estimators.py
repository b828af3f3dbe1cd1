"""ELBO gradient estimators.

Counterpart of ``brancher_tpu/inference/gradient_estimators.py``: each
estimator turns per-sample ``log_p`` / ``log_q`` tensors [S] into a scalar
surrogate loss whose autograd gradient is the chosen ELBO gradient
estimator.  ``detach_samples`` tells the SVI engine to cut the gradient
through the sampled values before the densities are evaluated;
``deterministic`` to evaluate at the guide's mean instead of sampling.
``jax.lax.stop_gradient`` is ``.detach()`` here.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


class GradientEstimator:
    detach_samples: bool = False
    deterministic: bool = False  # evaluate at the guide mean instead of sampling

    def surrogate_loss(self, log_p: Tensor, log_q: Tensor) -> Tensor:
        raise NotImplementedError


class PathwiseDerivativeEstimator(GradientEstimator):
    """Reparameterized (pathwise) gradients: requires a reparameterizable
    guide; gradients flow through the sampler itself."""

    def surrogate_loss(self, log_p, log_q):
        return -torch.mean(log_p - log_q)


class BlackBoxEstimator(GradientEstimator):
    """Score-function (REINFORCE) estimator; works for any guide, higher
    variance.  Samples are detached; the score term carries the gradient."""

    detach_samples = True

    def surrogate_loss(self, log_p, log_q):
        f = log_p - log_q
        return -torch.mean(f.detach() * log_q + f)


class Taylor1Estimator(GradientEstimator):
    """First-order Taylor (delta-method) approximation of the ELBO: the
    expectation is evaluated at the guide's mean point only, giving a
    deterministic, zero-variance (but biased) gradient."""

    deterministic = True

    def surrogate_loss(self, log_p, log_q):
        return -torch.mean(log_p - log_q)
