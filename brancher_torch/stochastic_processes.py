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

The HMMs (lines 312-583) need discrete enumeration and wait for it
(ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .distributions import REAL, Distribution, MultivariateNormal, Normal
from .variables import PartialLink, RandomVariable, to_tensor, var2link

Tensor = torch.Tensor


def _as_param(v, like: Tensor) -> Tensor:
    """A transition parameter as a tensor on ``like``'s device (a
    ``transition_fn`` may return python numbers)."""
    if isinstance(v, Tensor):
        return v
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


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


__all__ = ["MarkovSeries", "AutoRegressive", "ARProcess", "MarkovProcess",
           "observe_timeseries", "Timeseries"]
