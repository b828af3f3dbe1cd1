"""Time-series variables and Gaussian processes.

Counterpart of ``brancher_tpu/stochastic_processes.py`` (lines 28-309):
``MarkovSeries``, ``AutoRegressive``, ``ARProcess``, ``MarkovProcess``,
``observe_timeseries`` and ``Timeseries``, and the GP sugar
``rbf_kernel``, ``matern32_kernel`` and ``GaussianProcess``.  A whole
series is one random variable.  Its log-density is vectorized over time:
the transition density of x[t] depends only on the x[t-1..t-p] before it,
so all T terms evaluate at once from lagged views of the series and one
product, with no sequential dependence on the sampling path.  Sampling is
sequential by nature: the JAX package's ``lax.scan`` is a Python loop over
T here, with the noise of the whole series drawn up front.

A series' parameters may carry leading batch axes (its values are then
``batch + (T,)``); the compiler draws one series per walk, with 0-d or
[p] parameters.

A Gaussian process is one ``MultivariateNormal`` variable over its
function values at fixed inputs: the Gram matrix plus ``jitter`` I, built
inside the walk from the kernel's hyperparameters, which may be variables
(hyperpriors flow through the links).

The HMMs (lines 312-601): ``GaussianHMM`` and ``EmissionHMM`` sum their
state chain out of ``log_prob`` with the forward algorithm, and decode it
with ``posterior_marginals`` (forward-backward) and ``viterbi``; each of
JAX's ``lax.scan``s is a loop over T on tensors whose leading axes are
carried along, over a [T, ..., K] table of per-state emission
log-densities (for ``EmissionHMM`` the emission's ``log_prob`` broadcast
over the leading [K] axis of its parameters).  Their ``sample`` draws the
state path and then the emissions from the run's generator (JAX splits
keys: the draws agree in distribution only).  A MarkovSeries with a
Bernoulli or Categorical transition is summed out by the compiler's
sequence enumeration instead (``enumeration.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .distributions import _LOG_2PI, REAL, Distribution, MultivariateNormal, Normal, _gumbel
from .enumeration import _backward, _forward
from .variables import PartialLink, RandomVariable, to_tensor, var2link

Tensor = torch.Tensor


def _as_param(v, like: Tensor) -> Tensor:
    """A transition parameter as a tensor on ``like``'s device (a
    ``transition_fn`` may return python numbers)."""
    if isinstance(v, Tensor):
        return v
    dtype = like.dtype if like.dtype.is_floating_point else torch.get_default_dtype()
    return torch.as_tensor(v, dtype=dtype, device=like.device)


class MarkovSeries(Distribution):
    """First-order Markov chain of length T.

    The initial state's parameters come from links prefixed ``init_``; the
    transition's from ``transition_fn(prev, **link_params)``, which maps the
    previous state to the transition distribution's parameters.  Value
    shape: (T,) + state shape.
    """

    reparameterized = True
    support = REAL

    def __init__(self, length: int, transition_dist: Distribution,
                 transition_fn: Callable[..., Dict[str, Tensor]],
                 init_dist: Optional[Distribution] = None):
        self.length = int(length)
        self.transition_dist = transition_dist
        self.transition_fn = transition_fn
        self.init_dist = init_dist or transition_dist
        self.is_discrete = transition_dist.is_discrete
        self.support = transition_dist.support

    @staticmethod
    def _split_params(params):
        init_p = {k[len("init_"):]: v for k, v in params.items() if k.startswith("init_")}
        trans_p = {k: v for k, v in params.items() if not k.startswith("init_")}
        return init_p, trans_p

    def _transition(self, prev, trans_p):
        return {k: _as_param(v, prev) for k, v in self.transition_fn(prev, **trans_p).items()}

    def sample(self, generator, **params):
        init_p, trans_p = self._split_params(params)
        x = self.init_dist.sample(generator, **init_p)
        xs = [x]
        for _ in range(self.length - 1):
            x = self.transition_dist.sample(generator, **self._transition(x, trans_p))
            xs.append(x)
        return torch.stack(xs)

    def log_prob(self, value, **params):
        init_p, trans_p = self._split_params(params)
        lp0 = self.init_dist.log_prob(value[0], **init_p)
        # the parameters of x[t] depend only on x[t-1]: all t at once
        lps = self.transition_dist.log_prob(value[1:], **self._transition(value[:-1], trans_p))
        lp0 = torch.broadcast_to(lp0, lps.shape[1:])
        return torch.cat([lp0[None], lps], dim=0)


class AutoRegressive(Distribution):
    """AR(p) Gaussian series: x_t = sum_i c_i x_{t-i} + b + sigma eps_t,
    with the first p values N(init_loc, init_scale).  BASELINE config 3.
    Coefficients and noise come in as links, so priors over them work."""

    param_names = ("coefficients", "noise_scale", "bias", "init_loc", "init_scale")
    reparameterized = True
    support = REAL

    def __init__(self, length: int, order: int = 1):
        self.length = int(length)
        self.order = int(order)

    @staticmethod
    def lags(value: Tensor, order: int) -> Tensor:
        """[..., T] -> [..., T - p, p]: column i holds x_{t-1-i} for t >= p."""
        t = value.shape[-1]
        return torch.stack([value[..., order - 1 - i: t - 1 - i] for i in range(order)], dim=-1)

    def sample(self, generator, *, coefficients, noise_scale, bias=0.0, init_loc=0.0,
               init_scale=1.0):
        c = torch.atleast_1d(coefficients)
        p = self.order
        batch = torch.broadcast_shapes(c.shape[:-1], *(torch.as_tensor(v).shape for v in (
            noise_scale, bias, init_loc, init_scale)))
        like = dict(generator=generator, device=c.device, dtype=c.dtype)
        x0 = init_loc + init_scale * torch.randn(batch + (p,), **like)
        eps = noise_scale * torch.randn((self.length - p,) + batch, **like)
        window = list(torch.unbind(x0, dim=-1))  # oldest first
        xs = []
        for e in eps:
            x = bias + e
            for i in range(p):
                x = x + c[..., i] * window[-1 - i]
            window = window[1:] + [x]
            xs.append(x)
        return torch.cat([x0, torch.stack(xs, dim=-1)], dim=-1)

    def log_prob(self, value, *, coefficients, noise_scale, bias=0.0, init_loc=0.0,
                 init_scale=1.0):
        c = torch.atleast_1d(coefficients)
        p = self.order
        normal = Normal()
        init_lp = normal.log_prob(value[..., :p], loc=init_loc, scale=init_scale)
        # mean_t = sum_i c_i x_{t-i}: lagged views and one product, all t at once
        means = torch.matmul(self.lags(value, p), c.unsqueeze(-1)).squeeze(-1) + bias
        lp = normal.log_prob(value[..., p:], loc=means, scale=noise_scale)
        init_lp = torch.broadcast_to(init_lp, lp.shape[:-1] + (p,))
        return torch.cat([init_lp, lp], dim=-1)


def ARProcess(length: int, coefficients, noise_scale, name: Optional[str] = None,
              order: Optional[int] = None, bias=0.0, init_loc=0.0, init_scale=1.0,
              log_prob_scale: float = 1.0) -> RandomVariable:
    """AR(p) series variable; the order is len(coefficients) when they
    have a length, else 1."""
    if order is None:
        try:
            order = len(coefficients)
        except TypeError:
            order = 1
    return RandomVariable(
        AutoRegressive(length, order), name=name,
        links={"coefficients": coefficients, "noise_scale": noise_scale, "bias": bias,
               "init_loc": init_loc, "init_scale": init_scale},
        log_prob_scale=log_prob_scale,
    )


def MarkovProcess(length: int, transition_dist: Distribution,
                  transition_fn: Callable[..., Dict[str, Tensor]], name: Optional[str] = None,
                  init_dist: Optional[Distribution] = None, links: Optional[Dict] = None,
                  init_links: Optional[Dict] = None) -> RandomVariable:
    """Generic Markov-series variable, e.g. a linear-Gaussian latent chain::

        x = MarkovProcess(T, Normal(), lambda prev, a: {"loc": a * prev, "scale": 0.5},
                          links={"a": a_var}, init_links={"loc": 0.0, "scale": 1.0},
                          init_dist=Normal(), name="x")
    """
    all_links = dict(links or {})
    for k, v in (init_links or {}).items():
        all_links[f"init_{k}"] = v
    return RandomVariable(MarkovSeries(length, transition_dist, transition_fn, init_dist),
                          name=name, links=all_links)


def _as_columns(x) -> Tensor:
    x = torch.as_tensor(x)
    return x[:, None] if x.dim() == 1 else x


def rbf_kernel(x, lengthscale, variance) -> Tensor:
    """RBF (squared-exponential) Gram matrix of inputs x [N] or [N, D]."""
    x = _as_columns(x)
    d2 = torch.sum((x[:, None, :] - x[None, :, :]) ** 2, dim=-1)
    return variance * torch.exp(-0.5 * d2 / lengthscale**2)


def matern32_kernel(x, lengthscale, variance) -> Tensor:
    """Matern-3/2 Gram matrix of inputs x [N] or [N, D]."""
    x = _as_columns(x)
    d = torch.sqrt(torch.sum((x[:, None, :] - x[None, :, :]) ** 2, dim=-1) + 1e-12)
    s = math.sqrt(3.0) * d / lengthscale
    return variance * (1.0 + s) * torch.exp(-s)


_KERNELS = {"rbf": rbf_kernel, "matern32": matern32_kernel}


def GaussianProcess(inputs, lengthscale, variance, name: Optional[str] = None,
                    kernel: str = "rbf", mean=0.0, jitter: float = 1e-5) -> RandomVariable:
    """GP prior over the function values at fixed inputs: f ~ N(mean, K).

    ``lengthscale``, ``variance`` and ``mean`` take numbers, variables or
    expressions (a hyperprior composes; NUTS then samples it with f).  The
    Gram matrix is built in the walk, one [N, N] kernel and Cholesky an
    evaluation."""
    kfn = _KERNELS[kernel]
    x = to_tensor(np.asarray(inputs, np.float32))
    n = x.shape[0]
    ls_link, var_link, mean_link = var2link(lengthscale), var2link(variance), var2link(mean)

    def cov_fn(values, params):
        k = kfn(params.const(x), ls_link.fn(values, params), var_link.fn(values, params))
        return k + jitter * torch.eye(n, dtype=k.dtype, device=k.device)

    def loc_fn(values, params):
        return torch.broadcast_to(mean_link.fn(values, params), (n,))

    cov = PartialLink(tuple(ls_link.vars) + tuple(var_link.vars), cov_fn)
    loc = PartialLink(tuple(mean_link.vars), loc_fn)
    return RandomVariable(MultivariateNormal(), name=name,
                          links={"loc": loc, "covariance_matrix": cov})


def observe_timeseries(series_var: RandomVariable, data) -> None:
    """Observe a series with missing entries (NaN gaps).

    The NaNs' likelihood terms drop out through an elementwise mask, which
    the compiler multiplies into the log-prob before summing; for an AR(p)
    series every term whose lag window touches a missing value is masked
    too (its conditional mean would involve the unobserved point).  Missing
    positions hold 0 in the stored value, only to keep arithmetic finite.
    """
    arr = np.asarray(data, np.float32)
    finite = np.isfinite(arr)
    filled = np.where(finite, arr, 0.0).astype(np.float32)
    mask = finite.copy()
    if isinstance(series_var.distribution, AutoRegressive):
        p = series_var.distribution.order
        # term t >= p is valid only if x_t and its lags x_{t-1..t-p} are observed
        for i in range(1, p + 1):
            mask[p:] &= finite[p - i: arr.shape[0] - i]
    series_var.observe(filled)
    series_var.log_prob_mask = torch.from_numpy(mask.astype(np.float32))


def Timeseries(data):
    """(filled values, observation mask) of a partially observed series,
    NaN marking a missing value."""
    arr = np.asarray(data, np.float32)
    finite = np.isfinite(arr)
    return (torch.from_numpy(np.where(finite, arr, 0.0).astype(np.float32)),
            torch.from_numpy(finite.astype(np.float32)))


def _gather_state(table: Tensor, s: Tensor) -> Tensor:
    """table [..., K, *rest] at state s [...]: [..., *rest]."""
    idx = s.reshape(s.shape + (1,) * (table.dim() - s.dim()))
    idx = idx.expand(s.shape + (1,) + table.shape[s.dim() + 1:])
    return torch.gather(table, s.dim(), idx).squeeze(s.dim())


class _HMM(Distribution):
    """The recursions shared by the HMMs, over ``_emissions(value, params)``:
    a [T, ..., K] table of per-state emission log-densities."""

    reparameterized = False

    def __init__(self, length: int):
        self.length = int(length)

    def _chain(self, params):
        """(log initial [..., K], log transition [..., K, K]) probabilities."""
        return (torch.log_softmax(params["init_logits"], dim=-1),
                torch.log_softmax(params["trans_logits"], dim=-1))

    def log_prob(self, value, **params):
        """The forward algorithm in log space: one value per series (the
        time axis is the event)."""
        log_init, log_trans = self._chain(params)
        emis = self._emissions(value, params)
        alphas = _forward(log_init + emis[0], log_trans, emis, shared=True)
        return torch.logsumexp(alphas[-1], dim=-1)

    def posterior_marginals(self, value, **params):
        """Forward-backward smoothing p(s_t = k | y_{1:T}) as [..., T, K]."""
        log_init, log_trans = self._chain(params)
        emis = self._emissions(value, params)
        alphas = _forward(log_init + emis[0], log_trans, emis, shared=True)
        betas = _backward(log_trans, emis, shared=True)
        post = torch.softmax(torch.stack(alphas) + torch.stack(betas), dim=-1)
        return post.movedim(0, -2)

    def viterbi(self, value, **params):
        """The MAP state path argmax_s log p(s, y) as int64 [..., T]: the
        max-product forward recursion, then the backtrace (the first
        maximum wins a tie, as ``jnp.argmax``)."""
        log_init, log_trans = self._chain(params)
        emis = self._emissions(value, params)
        delta = log_init + emis[0]
        back = []
        for t in range(1, emis.shape[0]):
            scores = delta.unsqueeze(-1) + log_trans  # [..., K_prev, K_next]
            back.append(torch.argmax(scores, dim=-2))
            delta = torch.amax(scores, dim=-2) + emis[t]
        s = torch.argmax(delta, dim=-1)
        path = [s]
        for bp in reversed(back):
            s = torch.gather(bp, -1, s.unsqueeze(-1)).squeeze(-1)
            path.append(s)
        path.reverse()
        return torch.stack(path, dim=-1)

    def _states(self, generator, init_logits, trans_logits) -> Tensor:
        """A state path [T, ...] drawn from the chain (Gumbel-max)."""
        batch = torch.broadcast_shapes(init_logits.shape[:-1], trans_logits.shape[:-2])
        k = init_logits.shape[-1]
        g = _gumbel(generator, (self.length,) + batch + (k,), init_logits)
        s = torch.argmax(init_logits + g[0], dim=-1)
        trans = trans_logits.expand(batch + (k, k))
        states = [s]
        for t in range(1, self.length):
            s = torch.argmax(_gather_state(trans, s) + g[t], dim=-1)
            states.append(s)
        return torch.stack(states)


class GaussianHMM(_HMM):
    """Hidden Markov model with Gaussian emissions, the state chain summed
    out exactly by the forward algorithm: interacting discrete latents
    along time, which element-wise enumeration cannot take.

    Parameters (each may be a link, so priors over them make the HMM
    NUTS-able: the states never enter the sampler): init_logits [K],
    trans_logits [K, K] (rows normalize), locs [K], scales [K]; a value is
    [..., T] with any leading axes the parameters share."""

    param_names = ("init_logits", "trans_logits", "locs", "scales")
    param_event_ndims = {"init_logits": 1, "trans_logits": 2, "locs": 1, "scales": 1}
    support = REAL
    event_ndim = 1

    def _emissions(self, value, params):
        y = value.movedim(-1, 0).unsqueeze(-1)  # [T, ..., 1]
        locs, scales = params["locs"], params["scales"]
        return -0.5 * ((y - locs) / scales) ** 2 - torch.log(scales) - 0.5 * _LOG_2PI

    def sample(self, generator, *, init_logits, trans_logits, locs, scales):
        states = self._states(generator, init_logits, trans_logits)  # [T, ...]
        k = locs.shape[-1]
        batch = states.shape[1:]
        loc_t = torch.stack([_gather_state(locs.expand(batch + (k,)), s) for s in states])
        scale_t = torch.stack([_gather_state(scales.expand(batch + (k,)), s) for s in states])
        eps = torch.randn(states.shape, generator=generator, device=locs.device, dtype=locs.dtype)
        return (loc_t + scale_t * eps).movedim(0, -1)

    def mean(self, *, init_logits, trans_logits, locs, scales):
        m = torch.sum(torch.softmax(init_logits, dim=-1) * locs, dim=-1)
        return m.unsqueeze(-1).expand(m.shape + (self.length,))


class EmissionHMM(_HMM):
    """Hidden Markov model with any emission family: the state chain summed
    out by the same forward algorithm, the emissions from a
    :class:`Distribution` (Poisson counts, Bernoulli spikes, MVN
    observations).  Its parameters come with a LEADING STATE AXIS [K, ...]
    under link names ``emission_<param>``; init and transition logits as in
    GaussianHMM.  A value is [T, *event]; the emission table is the
    emission's log-density of each value broadcast over the [K] axis of
    the parameters, its event axes summed."""

    def __init__(self, length: int, emission: Distribution):
        super().__init__(length)
        self.emission = emission
        self.param_names = ("init_logits", "trans_logits") + tuple(
            f"emission_{p}" for p in emission.param_names)
        evr = {"init_logits": 1, "trans_logits": 2}
        base_evr = emission.param_event_ndims or {}
        for p in emission.param_names:
            evr[f"emission_{p}"] = base_evr.get(p, emission.event_ndim) + 1
        self.param_event_ndims = evr
        self.support = emission.support
        self.event_ndim = 1 + emission.event_ndim
        self.is_discrete = emission.is_discrete

    @staticmethod
    def _em(params):
        return {k[len("emission_"):]: v for k, v in params.items() if k.startswith("emission_")}

    def _emissions(self, value, params):
        em = self._em(params)
        k = params["init_logits"].shape[-1]
        y = value.unsqueeze(1)  # [T, 1, *event] against the params' [K, ...]
        lp = self.emission.log_prob(y, **em)
        lp = torch.broadcast_to(lp, (value.shape[0], k) + lp.shape[2:])
        return lp.reshape(value.shape[0], k, -1).sum(-1)

    def sample(self, generator, **params):
        states = self._states(generator, params["init_logits"], params["trans_logits"])
        return self.emission.sample(generator, **{p: v[states] for p, v in self._em(params).items()})

    def mean(self, **params):
        w = torch.softmax(params["init_logits"], dim=-1)
        m = self.emission.mean(**self._em(params))  # [K, *event]
        m = torch.tensordot(w, m, dims=([0], [0]))
        return m.unsqueeze(0).expand((self.length,) + m.shape)


def EmissionHMMVariable(length, emission: Distribution, init_logits, trans_logits,
                        name: Optional[str] = None, **emission_params) -> RandomVariable:
    """HMM series variable with any emission family.  ``emission_params``
    bind the emission's parameters with a leading state axis [K, ...]; each
    position takes constants, variables or expressions::

        rates = LogNormalVariable(0., 1., 'rates', plate_shape=(3,))
        y = EmissionHMMVariable(200, Poisson(), init_logits=np.zeros(3),
                                trans_logits=T0, rate=rates, name='y')
    """
    missing = set(emission.param_names) - set(emission_params)
    extra = set(emission_params) - set(emission.param_names)
    if missing or extra:
        raise ValueError(
            f"emission {type(emission).__name__} expects params {emission.param_names}; "
            f"missing {sorted(missing)}, unknown {sorted(extra)}")
    links = {"init_logits": init_logits, "trans_logits": trans_logits}
    links.update({f"emission_{p}": v for p, v in emission_params.items()})
    return RandomVariable(EmissionHMM(length, emission), name=name, links=links)


def hmm_posterior_marginals(value, *, init_logits, trans_logits, locs, scales) -> Tensor:
    """Forward-backward smoothing of a Gaussian HMM, p(s_t = k | y_{1:T}) as
    [T, K]: decode the states at fixed (or posterior-mean) parameters."""
    value = torch.as_tensor(value)
    params = {k: torch.as_tensor(v, dtype=value.dtype, device=value.device) for k, v in dict(
        init_logits=init_logits, trans_logits=trans_logits, locs=locs, scales=scales).items()}
    return GaussianHMM(value.shape[-1]).posterior_marginals(value, **params)


def HMMVariable(length, init_logits, trans_logits, locs, scales,
                name: Optional[str] = None) -> RandomVariable:
    """Gaussian-emission HMM series variable, its states marginalized.  Each
    parameter position takes constants, variables or expressions: put
    priors on locs, scales or transitions and run NUTS directly."""
    return RandomVariable(GaussianHMM(length), name=name, links={
        "init_logits": init_logits, "trans_logits": trans_logits, "locs": locs,
        "scales": scales})


__all__ = ["MarkovSeries", "AutoRegressive", "ARProcess", "MarkovProcess",
           "observe_timeseries", "Timeseries", "GaussianHMM", "EmissionHMM",
           "EmissionHMMVariable", "hmm_posterior_marginals", "HMMVariable"]
