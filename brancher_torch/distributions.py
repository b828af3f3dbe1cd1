"""Distribution kernels: counterpart of ``brancher_tpu/distributions.py``.

Each distribution is a stateless pair of functions on ONE sample (no
sample axis): ``sample(generator, **params)`` and ``log_prob(value,
**params)``, which returns an elementwise tensor that the compiler sums.
The chain or sample axis is added by ``torch.func.vmap`` or written out by
the caller, never inside a kernel.  Each log-density is the JAX package's
formula (not ``torch.distributions``' where the two differ); supports,
``event_ndim`` and ``param_event_ndims`` are as there.

The zoo: the location-scale families (Normal, LogNormal, HalfNormal,
Cauchy, HalfCauchy, Laplace, Logistic, StudentT, TruncatedNormal,
Uniform), the positive ones (Gamma, InverseGamma, Exponential, Chi2) and
Beta, the discrete ones (Bernoulli, Binomial, Poisson, Geometric,
Categorical) and the relaxed one-hot Concrete, MultivariateNormal
(Cholesky through ``torch.linalg``), Dirichlet, Delta, the data loaders
``Empirical`` and ``RandomIndices`` (which SVI resamples every step to
draw minibatches) and ``Mixture``, marginalised by a logsumexp over a
leading K axis of its component parameters.

Random draws take an explicit ``torch.Generator`` that lives on the
parameters' device; the draws differ from JAX's for the same seed, so
tests feed both packages the same numbers instead of the same seed.  The
gamma family draws through ``torch._standard_gamma``, whose gradient is
the implicit reparameterization, as ``jax.random.gamma``'s is.  The
families whose draw is a transform of standard-normal noise also take
that noise: ``from_noise(eps, **params)`` is ``sample`` with ``eps`` in
place of the generator's draw, so that a guide draws its noise outside
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
INTERVAL = "interval"  # (low, high), bounds read from the parameters
INTEGER = "integer"


def _bshape(*params) -> torch.Size:
    return torch.broadcast_shapes(*(p.shape for p in params))


def _dtype(*params) -> torch.dtype:
    dt = params[0].dtype
    for p in params[1:]:
        dt = torch.promote_types(dt, p.dtype)
    return dt if dt.is_floating_point else torch.get_default_dtype()


def _uniform(generator, shape, like: torch.Tensor, low: float = 0.0, high: float = 1.0):
    """Uniform draws in [low, high) on ``like``'s device, in its float dtype."""
    dt = like.dtype if like.dtype.is_floating_point else torch.get_default_dtype()
    u = torch.rand(shape, generator=generator, device=like.device, dtype=dt)
    return low + (high - low) * u


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without a threshold: ``torch.nn.functional.softplus``
    returns x itself above 20, ``jax.nn.softplus`` does not."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _gumbel(generator, shape, like: torch.Tensor) -> torch.Tensor:
    tiny = torch.finfo(like.dtype if like.dtype.is_floating_point else torch.float32).tiny
    u = _uniform(generator, shape, like).clamp(min=tiny)
    return -torch.log(-torch.log(u))


def _standard_gamma(generator, concentration: torch.Tensor, shape) -> torch.Tensor:
    """Gamma(concentration, 1) draws of ``shape``, reparameterized."""
    return torch._standard_gamma(torch.broadcast_to(concentration, shape).contiguous(),
                                 generator=generator)


class Distribution:
    """Base class: a named bundle of pure kernels (no state)."""

    param_names: tuple = ()
    # event rank PER PARAMETER (defaults to event_ndim for every param); lets
    # plate expansion broadcast e.g. an MVN's [d] loc and [d, d] scale_tril
    param_event_ndims: dict = {}
    reparameterized: bool = False
    is_discrete: bool = False
    support: str = REAL
    event_ndim: int = 0  # trailing event dims of a sampled value

    def sample(self, generator: torch.Generator, **params) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, value: torch.Tensor, **params) -> torch.Tensor:
        raise NotImplementedError

    def mean(self, **params) -> torch.Tensor:
        raise NotImplementedError

    def variance(self, **params) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


# ---------------------------------------------------------------------------
# Location-scale continuous families
# ---------------------------------------------------------------------------
class Normal(Distribution):
    param_names = ("loc", "scale")
    reparameterized = True
    support = REAL

    def sample(self, generator, *, loc, scale):
        eps = torch.randn(_bshape(loc, scale), generator=generator, device=loc.device,
                          dtype=_dtype(loc, scale))
        return self.from_noise(eps, loc=loc, scale=scale)

    def from_noise(self, eps, *, loc, scale):
        return loc + scale * eps

    def log_prob(self, value, *, loc, scale):
        z = (value - loc) / scale
        return -0.5 * (z * z + _LOG_2PI) - torch.log(scale)

    def mean(self, *, loc, scale):
        return torch.broadcast_to(loc, _bshape(loc, scale))

    def variance(self, *, loc, scale):
        return torch.broadcast_to(scale**2, _bshape(loc, scale))


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

    def variance(self, *, loc, scale):
        return (torch.exp(scale**2) - 1.0) * torch.exp(2 * loc + scale**2)


class HalfNormal(Distribution):
    param_names = ("scale",)
    reparameterized = True
    support = POSITIVE

    def sample(self, generator, *, scale):
        eps = torch.randn(scale.shape, generator=generator, device=scale.device,
                          dtype=_dtype(scale))
        return self.from_noise(eps, scale=scale)

    def from_noise(self, eps, *, scale):
        return torch.abs(scale * eps)

    def log_prob(self, value, *, scale):
        z = value / scale
        return -0.5 * (z * z + _LOG_2PI) - torch.log(scale) + math.log(2.0)

    def mean(self, *, scale):
        return scale * math.sqrt(2.0 / math.pi)

    def variance(self, *, scale):
        return scale**2 * (1.0 - 2.0 / math.pi)


class Cauchy(Distribution):
    param_names = ("loc", "scale")
    reparameterized = True
    support = REAL

    def sample(self, generator, *, loc, scale):
        # the inverse CDF tan(pi (u - 1/2)), as jax.random.cauchy
        u = _uniform(generator, _bshape(loc, scale), loc)
        return loc + scale * torch.tan(math.pi * (u - 0.5))

    def log_prob(self, value, *, loc, scale):
        z = (value - loc) / scale
        return -torch.log1p(z * z) - torch.log(scale) - math.log(math.pi)


class HalfCauchy(Distribution):
    param_names = ("scale",)
    reparameterized = True
    support = POSITIVE

    def sample(self, generator, *, scale):
        return torch.abs(Cauchy().sample(generator, loc=torch.zeros_like(scale), scale=scale))

    def log_prob(self, value, *, scale):
        z = value / scale
        return -torch.log1p(z * z) - torch.log(scale) + math.log(2.0 / math.pi)


class Laplace(Distribution):
    param_names = ("loc", "scale")
    reparameterized = True
    support = REAL

    def sample(self, generator, *, loc, scale):
        u = _uniform(generator, _bshape(loc, scale), loc, -1.0, 1.0)
        return loc - scale * torch.sign(u) * torch.log1p(-torch.abs(u))

    def log_prob(self, value, *, loc, scale):
        return -torch.abs(value - loc) / scale - torch.log(2.0 * scale)

    def mean(self, *, loc, scale):
        return torch.broadcast_to(loc, _bshape(loc, scale))

    def variance(self, *, loc, scale):
        return torch.broadcast_to(2.0 * scale**2, _bshape(loc, scale))


class Logistic(Distribution):
    param_names = ("loc", "scale")
    reparameterized = True
    support = REAL

    def sample(self, generator, *, loc, scale):
        tiny = torch.finfo(_dtype(loc, scale)).tiny
        u = _uniform(generator, _bshape(loc, scale), loc).clamp(min=tiny)
        return loc + scale * (torch.log(u) - torch.log1p(-u))

    def log_prob(self, value, *, loc, scale):
        z = (value - loc) / scale
        return -z - 2.0 * softplus(-z) - torch.log(scale)


class StudentT(Distribution):
    param_names = ("df", "loc", "scale")
    reparameterized = True
    support = REAL

    def sample(self, generator, *, df, loc, scale):
        # a standard normal over sqrt(chi2_df / df), as jax.random.t
        shape = _bshape(df, loc, scale)
        n = torch.randn(shape, generator=generator, device=loc.device, dtype=_dtype(loc, scale))
        g = _standard_gamma(generator, 0.5 * df, shape)
        return loc + scale * n * torch.rsqrt(g / (0.5 * df))

    def log_prob(self, value, *, df, loc, scale):
        z = (value - loc) / scale
        return (torch.lgamma(0.5 * (df + 1.0)) - torch.lgamma(0.5 * df)
                - 0.5 * torch.log(df * math.pi) - torch.log(scale)
                - 0.5 * (df + 1.0) * torch.log1p(z * z / df))


class TruncatedNormal(Distribution):
    """Normal truncated to [low, high], sampled by the inverse CDF (ndtri):
    shape-static and reparameterized, unlike rejection sampling."""

    param_names = ("loc", "scale", "low", "high")
    reparameterized = True
    support = INTERVAL

    @staticmethod
    def _cdf_bounds(loc, scale, low, high):
        return (torch.special.ndtr((low - loc) / scale), torch.special.ndtr((high - loc) / scale))

    def sample(self, generator, *, loc, scale, low, high):
        a, b = self._cdf_bounds(loc, scale, low, high)
        u = _uniform(generator, _bshape(loc, scale, low, high), loc, 1e-6, 1.0 - 1e-6)
        return loc + scale * torch.special.ndtri(a + (b - a) * u)

    def log_prob(self, value, *, loc, scale, low, high):
        a, b = self._cdf_bounds(loc, scale, low, high)
        z = (value - loc) / scale
        lp = -0.5 * (z * z + _LOG_2PI) - torch.log(scale) - torch.log(b - a)
        inside = (value >= low) & (value <= high)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))


class Uniform(Distribution):
    param_names = ("low", "high")
    reparameterized = True
    support = INTERVAL

    def sample(self, generator, *, low, high):
        u = _uniform(generator, _bshape(low, high), low)
        return low + (high - low) * u

    def log_prob(self, value, *, low, high):
        inside = (value >= low) & (value <= high)
        lp = torch.broadcast_to(-torch.log(high - low), inside.shape)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def mean(self, *, low, high):
        return 0.5 * (low + high)

    def variance(self, *, low, high):
        return (high - low) ** 2 / 12.0


# ---------------------------------------------------------------------------
# Positive-support families and Beta
# ---------------------------------------------------------------------------
class Gamma(Distribution):
    param_names = ("concentration", "rate")
    reparameterized = True  # implicit reparameterization of the gamma draw
    support = POSITIVE

    def sample(self, generator, *, concentration, rate):
        return _standard_gamma(generator, concentration, _bshape(concentration, rate)) / rate

    def log_prob(self, value, *, concentration, rate):
        return (concentration * torch.log(rate) + (concentration - 1.0) * torch.log(value)
                - rate * value - torch.lgamma(concentration))

    def mean(self, *, concentration, rate):
        return concentration / rate

    def variance(self, *, concentration, rate):
        return concentration / rate**2


class InverseGamma(Distribution):
    param_names = ("concentration", "scale")
    reparameterized = True
    support = POSITIVE

    def sample(self, generator, *, concentration, scale):
        return 1.0 / Gamma().sample(generator, concentration=concentration, rate=scale)

    def log_prob(self, value, *, concentration, scale):
        return (concentration * torch.log(scale) - (concentration + 1.0) * torch.log(value)
                - scale / value - torch.lgamma(concentration))


class Exponential(Distribution):
    param_names = ("rate",)
    reparameterized = True
    support = POSITIVE

    def sample(self, generator, *, rate):
        u = _uniform(generator, rate.shape, rate)
        return -torch.log1p(-u) / rate

    def log_prob(self, value, *, rate):
        return torch.log(rate) - rate * value

    def mean(self, *, rate):
        return 1.0 / rate

    def variance(self, *, rate):
        return 1.0 / rate**2


class Chi2(Distribution):
    param_names = ("df",)
    reparameterized = True
    support = POSITIVE

    def sample(self, generator, *, df):
        return Gamma().sample(generator, concentration=0.5 * df, rate=torch.full_like(df, 0.5))

    def log_prob(self, value, *, df):
        return Gamma().log_prob(value, concentration=0.5 * df,
                                rate=torch.full_like(torch.as_tensor(df), 0.5))


class Beta(Distribution):
    param_names = ("alpha", "beta")
    reparameterized = True
    support = UNIT_INTERVAL

    def sample(self, generator, *, alpha, beta):
        shape = _bshape(alpha, beta)
        ga = _standard_gamma(generator, alpha, shape)
        gb = _standard_gamma(generator, beta, shape)
        return ga / (ga + gb)

    def log_prob(self, value, *, alpha, beta):
        return ((alpha - 1.0) * torch.log(value) + (beta - 1.0) * torch.log1p(-value)
                - (torch.lgamma(alpha) + torch.lgamma(beta) - torch.lgamma(alpha + beta)))

    def mean(self, *, alpha, beta):
        return alpha / (alpha + beta)

    def variance(self, *, alpha, beta):
        s = alpha + beta
        return alpha * beta / (s * s * (s + 1.0))


# ---------------------------------------------------------------------------
# Discrete families
# ---------------------------------------------------------------------------
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
        return torch.bernoulli(torch.sigmoid(logits), generator=generator).to(torch.int32)

    def log_prob(self, value, *, probs=None, logits=None):
        logits = _resolve_probs_logits(probs, logits)
        v = torch.as_tensor(value).to(logits.dtype)
        return v * logits - softplus(logits)

    def mean(self, *, probs=None, logits=None):
        return torch.sigmoid(_resolve_probs_logits(probs, logits))

    def variance(self, *, probs=None, logits=None):
        p = self.mean(probs=probs, logits=logits)
        return p * (1.0 - p)


class Binomial(Distribution):
    param_names = ("total_count", "probs", "logits")
    is_discrete = True
    support = INTEGER

    def sample(self, generator, *, total_count, probs=None, logits=None):
        p = torch.sigmoid(_resolve_probs_logits(probs, logits))
        n = torch.as_tensor(total_count).to(p.dtype)
        shape = _bshape(n, p)
        return torch.binomial(torch.broadcast_to(n, shape).contiguous(),
                              torch.broadcast_to(p, shape).contiguous(),
                              generator=generator).to(torch.int32)

    def log_prob(self, value, *, total_count, probs=None, logits=None):
        logits = _resolve_probs_logits(probs, logits)
        n = torch.as_tensor(total_count).to(logits.dtype)
        v = torch.as_tensor(value).to(logits.dtype)
        log_comb = torch.lgamma(n + 1.0) - torch.lgamma(v + 1.0) - torch.lgamma(n - v + 1.0)
        return log_comb + v * logits - n * softplus(logits)


class Poisson(Distribution):
    param_names = ("rate",)
    is_discrete = True
    support = INTEGER

    def sample(self, generator, *, rate):
        return torch.poisson(rate, generator=generator).to(torch.int32)

    def log_prob(self, value, *, rate):
        v = torch.as_tensor(value).to(_dtype(rate))
        return v * torch.log(rate) - rate - torch.lgamma(v + 1.0)


class Geometric(Distribution):
    """Number of failures before the first success; support {0, 1, ...}."""

    param_names = ("probs", "logits")
    is_discrete = True
    support = INTEGER

    def sample(self, generator, *, probs=None, logits=None):
        p = torch.sigmoid(_resolve_probs_logits(probs, logits))
        u = _uniform(generator, p.shape, p)
        return torch.floor(torch.log1p(-u) / torch.log1p(-p)).to(torch.int32)

    def log_prob(self, value, *, probs=None, logits=None):
        logits = _resolve_probs_logits(probs, logits)
        v = torch.as_tensor(value).to(logits.dtype)
        return -softplus(-logits) + v * (-softplus(logits))


class Categorical(Distribution):
    """Integer-valued categorical; the trailing parameter axis indexes the
    classes.  Draws are int64 (torch's index type; JAX draws int32)."""

    param_names = ("probs", "logits")
    is_discrete = True
    support = INTEGER
    event_ndim = 0  # the value drops the class axis

    @staticmethod
    def _logits(probs, logits):
        if (probs is None) == (logits is None):
            raise ValueError("exactly one of probs/logits must be given")
        return torch.log(probs) if logits is None else logits

    def sample(self, generator, *, probs=None, logits=None):
        lg = self._logits(probs, logits)
        return torch.argmax(lg + _gumbel(generator, lg.shape, lg), dim=-1)

    def log_prob(self, value, *, probs=None, logits=None):
        lg = torch.log_softmax(self._logits(probs, logits), dim=-1)
        idx = torch.as_tensor(value).to(torch.int64)
        shape = torch.broadcast_shapes(lg.shape[:-1], idx.shape)
        lg, idx = lg.expand(shape + lg.shape[-1:]), idx.expand(shape)
        return torch.gather(lg, -1, idx[..., None])[..., 0]


class Concrete(Distribution):
    """Gumbel-softmax relaxed one-hot (Maddison et al.): a point on the
    simplex, the trailing class axis its event dim, reparameterized."""

    param_names = ("temperature", "logits")
    param_event_ndims = {"temperature": 0, "logits": 1}
    reparameterized = True
    support = SIMPLEX
    event_ndim = 1

    def sample(self, generator, *, temperature, logits):
        g = _gumbel(generator, logits.shape, logits)
        return torch.softmax((logits + g) / temperature, dim=-1)

    def log_prob(self, value, *, temperature, logits):
        k = logits.shape[-1]
        t = temperature
        logv = torch.log(value)
        score = logits - t * logv
        norm = torch.logsumexp(score, dim=-1, keepdim=True)
        return (math.lgamma(float(k)) + (k - 1) * torch.log(t)
                + torch.sum(score - norm, dim=-1) - torch.sum(logv, dim=-1))


# ---------------------------------------------------------------------------
# Multivariate families
# ---------------------------------------------------------------------------
class MultivariateNormal(Distribution):
    """MVN with loc and either a covariance or its Cholesky factor; a
    covariance is factorised once per call (``torch.linalg.cholesky_ex``,
    which does not wait for the card to check the factorisation; a matrix
    that is not positive definite gives NaN, as ``jnp.linalg.cholesky``
    does)."""

    param_names = ("loc", "covariance_matrix", "scale_tril")
    param_event_ndims = {"loc": 1, "covariance_matrix": 2, "scale_tril": 2}
    reparameterized = True
    support = REAL
    event_ndim = 1

    @staticmethod
    def _chol(covariance_matrix, scale_tril):
        if (covariance_matrix is None) == (scale_tril is None):
            raise ValueError("exactly one of covariance_matrix/scale_tril required")
        if scale_tril is None:
            scale_tril, info = torch.linalg.cholesky_ex(covariance_matrix)
            scale_tril = torch.where((info == 0)[..., None, None], scale_tril,
                                     torch.full_like(scale_tril, math.nan))
        return scale_tril

    def sample(self, generator, *, loc, covariance_matrix=None, scale_tril=None):
        L = self._chol(covariance_matrix, scale_tril)
        shape = torch.broadcast_shapes(loc.shape, L.shape[:-1])
        eps = torch.randn(shape, generator=generator, device=L.device, dtype=L.dtype)
        return self.from_noise(eps, loc=loc, scale_tril=L)

    def from_noise(self, eps, *, loc, covariance_matrix=None, scale_tril=None):
        L = self._chol(covariance_matrix, scale_tril)
        return loc + torch.einsum("...ij,...j->...i", L, eps)

    def log_prob(self, value, *, loc, covariance_matrix=None, scale_tril=None):
        L = self._chol(covariance_matrix, scale_tril)
        d = value.shape[-1]
        diff = value - loc
        z = torch.linalg.solve_triangular(L, diff[..., None], upper=False)[..., 0]
        logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        return -0.5 * torch.sum(z * z, dim=-1) - logdet - 0.5 * d * _LOG_2PI

    def mean(self, *, loc, covariance_matrix=None, scale_tril=None):
        return loc


class Dirichlet(Distribution):
    param_names = ("concentration",)
    reparameterized = True
    support = SIMPLEX
    event_ndim = 1

    def sample(self, generator, *, concentration):
        g = _standard_gamma(generator, concentration, concentration.shape)
        return g / torch.sum(g, dim=-1, keepdim=True)

    def log_prob(self, value, *, concentration):
        return (torch.sum((concentration - 1.0) * torch.log(value), dim=-1)
                + torch.lgamma(torch.sum(concentration, dim=-1))
                - torch.sum(torch.lgamma(concentration), dim=-1))

    def mean(self, *, concentration):
        return concentration / torch.sum(concentration, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Degenerate and data distributions
# ---------------------------------------------------------------------------
class Delta(Distribution):
    """Point mass; its log-density is 0 (the continuous convention)."""

    param_names = ("value",)
    reparameterized = True
    support = REAL

    def sample(self, generator, *, value):
        return value

    def log_prob(self, x, *, value):
        return torch.zeros(_bshape(torch.as_tensor(x), value), device=value.device)

    def mean(self, *, value):
        return value


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


# name-based lookup, as the JAX package's registry
DISTRIBUTIONS = {
    cls.__name__: cls
    for cls in [
        Normal, LogNormal, HalfNormal, Cauchy, HalfCauchy, Laplace, Logistic,
        StudentT, Uniform, Gamma, InverseGamma, Exponential, Chi2, Beta,
        TruncatedNormal, Bernoulli, Binomial, Poisson, Geometric, Categorical, Concrete,
        MultivariateNormal, Dirichlet, Delta, Empirical, RandomIndices,
    ]
}


class Mixture(Distribution):
    """Finite mixture with the component assignment MARGINALISED.

    Component parameters carry a leading K axis; ``log_prob`` is the
    logsumexp over components, smooth in every continuous parameter, so a
    mixture is an HMC/NUTS likelihood or latent with no discrete latent in
    the sampler::

        Mixture(Normal()).log_prob(x, probs=w[K], loc=mu[K], scale=sig[K])
    """

    def __init__(self, component_dist: Distribution):
        self.component = component_dist
        self.param_names = ("probs", "logits") + tuple(component_dist.param_names)
        self.support = component_dist.support
        self.reparameterized = False  # a draw picks a discrete index

    @staticmethod
    def _log_weights(probs, logits):
        if (probs is None) == (logits is None):
            raise ValueError("exactly one of probs/logits must be given")
        return torch.log(probs) if logits is None else torch.log_softmax(logits, dim=-1)

    @staticmethod
    def _expand(v, k):
        """Every component parameter with a leading K axis (scalars and
        shared parameters broadcast)."""
        v = torch.as_tensor(v)
        if v.dim() == 0:
            return torch.broadcast_to(v, (k,))
        if v.shape[0] == k:
            return v
        return torch.broadcast_to(v, (k,) + tuple(v.shape))

    def sample(self, generator, *, probs=None, logits=None, **comp_params):
        lw = self._log_weights(probs, logits)
        k_n = lw.shape[0]
        comp_params = {k: self._expand(v, k_n) for k, v in comp_params.items()}
        idx = Categorical().sample(generator, logits=lw)
        chosen = {k: v[idx] for k, v in comp_params.items()}
        return self.component.sample(generator, **chosen)

    def log_prob(self, value, *, probs=None, logits=None, **comp_params):
        lw = self._log_weights(probs, logits)  # [K]
        k = lw.shape[0]
        comp_params = {n: self._expand(v, k) for n, v in comp_params.items()}
        ev = self.component.event_ndim
        lps = []
        for i in range(k):
            lp = self.component.log_prob(value, **{n: v[i] for n, v in comp_params.items()})
            if ev:  # reduce the event dims, so mixing happens per data point
                lp = torch.sum(lp, dim=tuple(range(-ev, 0)))
            lps.append(lp)
        lps = torch.stack(lps)  # [K, ...]
        return torch.logsumexp(lps + lw.reshape((k,) + (1,) * (lps.dim() - 1)), dim=0)

    def mean(self, *, probs=None, logits=None, **comp_params):
        w = torch.exp(self._log_weights(probs, logits))
        comp_params = {n: self._expand(v, w.shape[0]) for n, v in comp_params.items()}
        means = torch.stack([self.component.mean(**{n: v[i] for n, v in comp_params.items()})
                             for i in range(w.shape[0])])
        return torch.tensordot(w, means, dims=([0], [0]))


DISTRIBUTIONS["Mixture"] = Mixture
