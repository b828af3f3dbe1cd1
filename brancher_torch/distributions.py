"""Distribution kernels: a subset of ``brancher_tpu/distributions.py``.

Each distribution is a stateless pair of functions on ONE sample (no
sample axis): ``sample(generator, **params)`` and ``log_prob(value,
**params)``, which returns an elementwise tensor that the compiler sums.
The chain or sample axis is added by ``torch.func.vmap`` or written out by
the caller, never inside a kernel.

Ported so far: Normal, LogNormal and Bernoulli (logits or probs), the
families on the main sampling path, with their ``mean``; and the data
loaders ``Empirical`` and ``RandomIndices`` (lines 618-670), which SVI
resamples every step to draw minibatches.  The other families of the JAX
package are still to port (ROADMAP queue 1, item 14).

Random draws take an explicit ``torch.Generator`` that lives on the
parameters' device; the draws differ from JAX's for the same seed, so
tests feed both packages the same numbers instead of the same seed.  The
reparameterized families also take their standard-normal noise:
``from_noise(eps, **params)`` is ``sample`` with ``eps`` in place of the
generator's draw, so that a guide draws its noise outside
``torch.func.vmap`` and a test can replay JAX's.
"""
from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)

# Supports (constraints), the same string tags as the JAX package.
REAL = "real"
POSITIVE = "positive"
UNIT_INTERVAL = "unit_interval"
SIMPLEX = "simplex"
INTERVAL = "interval"
INTEGER = "integer"


def _bshape(*params) -> torch.Size:
    return torch.broadcast_shapes(*(p.shape for p in params))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without a threshold: ``torch.nn.functional.softplus``
    returns x itself above 20, ``jax.nn.softplus`` does not."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


class Distribution:
    """Base class: a named bundle of pure kernels (no state)."""

    param_names: tuple = ()
    reparameterized: bool = False
    is_discrete: bool = False
    support: str = REAL
    event_ndim: int = 0

    def sample(self, generator: torch.Generator, **params) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, value: torch.Tensor, **params) -> torch.Tensor:
        raise NotImplementedError

    def mean(self, **params) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class Normal(Distribution):
    param_names = ("loc", "scale")
    reparameterized = True
    support = REAL

    def sample(self, generator, *, loc, scale):
        eps = torch.randn(
            _bshape(loc, scale), generator=generator, device=loc.device,
            dtype=torch.result_type(loc, scale),
        )
        return self.from_noise(eps, loc=loc, scale=scale)

    def from_noise(self, eps, *, loc, scale):
        return loc + scale * eps

    def log_prob(self, value, *, loc, scale):
        z = (value - loc) / scale
        return -0.5 * (z * z + _LOG_2PI) - torch.log(scale)

    def mean(self, *, loc, scale):
        return torch.broadcast_to(loc, _bshape(loc, scale))


class LogNormal(Distribution):
    param_names = ("loc", "scale")
    reparameterized = True
    support = POSITIVE

    def sample(self, generator, *, loc, scale):
        return torch.exp(Normal().sample(generator, loc=loc, scale=scale))

    def from_noise(self, eps, *, loc, scale):
        return torch.exp(Normal().from_noise(eps, loc=loc, scale=scale))

    def log_prob(self, value, *, loc, scale):
        logv = torch.log(value)
        return Normal().log_prob(logv, loc=loc, scale=scale) - logv

    def mean(self, *, loc, scale):
        return torch.exp(loc + 0.5 * scale**2)


def _resolve_probs_logits(probs, logits):
    if (probs is None) == (logits is None):
        raise ValueError("exactly one of probs/logits must be given")
    if probs is not None:
        logits = torch.log(probs) - torch.log1p(-probs)
    return logits


class Bernoulli(Distribution):
    param_names = ("probs", "logits")
    is_discrete = True
    support = INTEGER

    def sample(self, generator, *, probs=None, logits=None):
        logits = _resolve_probs_logits(probs, logits)
        return torch.bernoulli(torch.sigmoid(logits), generator=generator).to(
            torch.int32
        )

    def log_prob(self, value, *, probs=None, logits=None):
        logits = _resolve_probs_logits(probs, logits)
        v = torch.as_tensor(value).to(logits.dtype)
        return v * logits - softplus(logits)

    def mean(self, *, probs=None, logits=None):
        return torch.sigmoid(_resolve_probs_logits(probs, logits))


class Empirical(Distribution):
    """Rows of a fixed dataset: ``dataset[indices]`` when indices are given,
    else ``batch_size`` rows drawn uniformly with replacement, else the
    whole dataset.  Density-free: ``log_prob`` is one zero per row (a bare
    zero for a scalar value), as in the JAX package.  ``is_discrete``, so it
    never enters an HMC state."""

    param_names = ("dataset", "indices")
    is_discrete = True
    support = REAL

    def __init__(self, batch_size=None):
        self.batch_size = batch_size

    def sample(self, generator, *, dataset, indices=None):
        if indices is not None:
            return dataset[indices]
        if self.batch_size is None:
            return dataset
        idx = torch.randint(0, dataset.shape[0], (self.batch_size,), generator=generator,
                            device=dataset.device)
        return dataset[idx]

    def log_prob(self, value, *, dataset, indices=None):
        return torch.zeros(value.shape[:1], device=value.device)


class RandomIndices(Distribution):
    """``batch_size`` minibatch indices in [0, dataset_size), uniform with
    replacement (int64, torch's index type; JAX draws int32)."""

    param_names = ()
    is_discrete = True
    support = INTEGER

    def __init__(self, dataset_size: int, batch_size: int):
        self.dataset_size = int(dataset_size)
        self.batch_size = int(batch_size)

    def sample(self, generator):
        return torch.randint(0, self.dataset_size, (self.batch_size,), generator=generator,
                             device=generator.device)

    def log_prob(self, value):
        return torch.zeros((), device=value.device)
