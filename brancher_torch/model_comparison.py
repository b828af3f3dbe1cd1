"""Predictive model comparison: WAIC and PSIS-LOO.

Counterpart of ``brancher_tpu/model_comparison.py``: WAIC (Watanabe 2010)
and Pareto-smoothed importance-sampling leave-one-out cross-validation
(Vehtari, Gelman & Gabry 2017), with ``compare``.

The [draws, n_points] pointwise log-likelihood matrix is evaluated on the
model's device as ONE ``torch.func.vmap`` over the posterior draws
(``CompiledModel.pointwise_log_likelihood``); the statistics (logsumexp
moments, the generalized-Pareto tail fits) are host numpy in float64, the
JAX package's own arithmetic, so the same matrix gives the same numbers.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch


class ELPDResult(NamedTuple):
    """Expected log pointwise predictive density estimate."""

    elpd: float  # sum over points
    se: float  # standard error of elpd (over points)
    p_eff: float  # effective number of parameters
    deviance: float  # -2 * elpd (WAIC / LOOIC scale)
    pointwise: np.ndarray  # [n_points] elpd contributions
    pareto_k: Optional[np.ndarray] = None  # [n_points], PSIS-LOO only
    method: str = ""

    def __repr__(self):
        extra = ""
        if self.pareto_k is not None:
            n_bad = int(np.sum(self.pareto_k > 0.7))
            extra = f" pareto_k>0.7: {n_bad}"
        return (
            f"<{self.method} elpd={self.elpd:.1f} se={self.se:.1f} "
            f"p_eff={self.p_eff:.1f}{extra}>"
        )


def pointwise_log_likelihood(model, result, params=None, max_draws: int = 1000,
                             given=None, device=None) -> np.ndarray:
    """[draws, n_observed_points] pointwise log-likelihood matrix from an
    MCMCResult (or a {name: [chains, draws, ...]} dict of posterior
    samples), as float64 numpy.

    Draws are pooled over chains and thinned uniformly to ``max_draws``;
    the matrix is evaluated on the model's device (``device``, default
    ``config.device``; a CompiledModel keeps its own), batched over the
    draws.  Points masked out by a missing-data ``log_prob_mask`` (e.g.
    ``observe_timeseries`` with NaNs) are DROPPED: they would otherwise
    add elpd terms of exactly 0 and inflate the p_eff and SE accounting.
    """
    comp = model.compiled(device) if hasattr(model, "compiled") else model
    if params is None:
        params = comp.initial_params
    samples = result.samples if hasattr(result, "samples") else dict(result)
    names = [n for n in comp.continuous_latent_names if n in samples]
    if not names:
        raise ValueError("no continuous latent samples found in result")

    flat = {}
    total = None
    for n in names:
        arr = samples[n]
        arr = torch.as_tensor(arr if isinstance(arr, torch.Tensor) else np.array(arr),
                              device=comp.device)
        arr = arr.reshape((-1,) + tuple(arr.shape[2:]))
        total = arr.shape[0] if total is None else total
        flat[n] = arr
    stride = max(1, total // max_draws)
    flat = {n: a[::stride] for n, a in flat.items()}
    if given is not None:
        given = {k: torch.as_tensor(v, device=comp.device) for k, v in given.items()}

    with torch.no_grad():
        pls = torch.func.vmap(
            lambda vals: comp.pointwise_log_likelihood(params, vals, given))(flat)
    s = next(iter(flat.values())).shape[0]
    out = torch.cat([pls[k].reshape(s, -1) for k in sorted(pls)], dim=1)
    out = out.double().cpu().numpy()
    keep = _observed_keep_mask(comp, {k: tuple(v.shape[1:]) for k, v in pls.items()})
    if keep is not None and not keep.all():
        out = out[:, keep]
    return out


def _observed_keep_mask(comp, shapes):
    """Boolean [n_points] mask in the sorted-name ravel order of the
    pointwise matrix: True where the point is observed, False where a
    missing-data ``log_prob_mask`` zeroes it.  None when no observed
    variable carries a mask."""
    by_name = {v.name: v for v in comp.order}
    if not any(getattr(by_name.get(k), "log_prob_mask", None) is not None for k in shapes):
        return None
    parts = []
    for k in sorted(shapes):
        shp = shapes[k]
        m = getattr(by_name.get(k), "log_prob_mask", None)
        if m is None:
            parts.append(np.ones(int(np.prod(shp)), dtype=bool))
        else:
            parts.append(np.broadcast_to(np.asarray(m) != 0, shp).ravel())
    return np.concatenate(parts) if parts else None


def waic(model, result, params=None, max_draws: int = 1000,
         given=None, device=None) -> ELPDResult:
    """WAIC (Watanabe-Akaike information criterion), Vehtari et al. eq 10-12.

    ``given`` conditions the model exactly as in ``sample(given=...)``; it
    is forwarded to the pointwise log-likelihood walk, pinning e.g.
    data-loader indices to the evaluation set."""
    ll = pointwise_log_likelihood(model, result, params, max_draws, given, device)
    s = ll.shape[0]
    lppd_i = _logmeanexp(ll, axis=0)
    p_i = np.var(ll, axis=0, ddof=1)
    elpd_i = lppd_i - p_i
    return _pack(elpd_i, float(np.sum(p_i)), "WAIC")


def loo(model, result, params=None, max_draws: int = 1000,
        given=None, device=None) -> ELPDResult:
    """PSIS-LOO cross-validation (Vehtari, Gelman & Gabry 2017).

    ``given`` conditions the model exactly as in ``sample(given=...)``
    (see ``waic``)."""
    ll = pointwise_log_likelihood(model, result, params, max_draws, given, device)
    elpd_i, ks = _psis_elpd(ll)
    lppd_i = _logmeanexp(ll, axis=0)
    p_eff = float(np.sum(lppd_i - elpd_i))
    res = _pack(elpd_i, p_eff, "PSIS-LOO")
    return res._replace(pareto_k=ks)


def compare(results: Dict[str, ELPDResult]) -> str:
    """Rank models by elpd; returns a fixed-width report (best first)
    with pairwise elpd differences and their standard errors."""
    order = sorted(results, key=lambda k: -results[k].elpd)
    best = results[order[0]]
    lines = [f"{'model':<20} {'elpd':>10} {'se':>8} {'d_elpd':>10} {'d_se':>8} {'p_eff':>8}"]
    for name in order:
        r = results[name]
        d = r.elpd - best.elpd
        # se of the DIFFERENCE uses pointwise pairing (ibid. §5.2)
        if r is best:
            d_se = 0.0
        else:
            diff = r.pointwise - best.pointwise
            d_se = float(np.sqrt(len(diff) * np.var(diff)))
        lines.append(
            f"{name:<20} {r.elpd:>10.1f} {r.se:>8.1f} {d:>10.1f} "
            f"{d_se:>8.1f} {r.p_eff:>8.1f}"
        )
    return "\n".join(lines)


# ----------------------------------------------------------------------
# internals
# ----------------------------------------------------------------------

def _logmeanexp(x, axis=0):
    m = np.max(x, axis=axis)
    return m + np.log(np.mean(np.exp(x - m), axis=axis))


def _pack(elpd_i: np.ndarray, p_eff: float, method: str) -> ELPDResult:
    n = elpd_i.shape[0]
    elpd = float(np.sum(elpd_i))
    se = float(np.sqrt(n * np.var(elpd_i)))
    return ELPDResult(elpd=elpd, se=se, p_eff=p_eff, deviance=-2.0 * elpd,
                      pointwise=elpd_i, method=method)


def _gpd_fit(x: np.ndarray):
    """Generalized-Pareto (k, sigma) fit by the Zhang & Stephens (2009)
    quasi-Bayes profile method, in the MODERN shape convention (k = xi:
    positive = heavy tail).  With theta = -k/sigma the profile MLE is
    k(theta) = mean(log(1 - theta x)) and the profile log-likelihood is
    n*(log(-theta/k) - k - 1)."""
    x = np.sort(x)
    n = x.shape[0]
    prior_bs = 3.0
    m_est = 30 + int(np.sqrt(n))
    b = 1.0 - np.sqrt(m_est / (np.arange(1, m_est + 1) - 0.5))
    b = b / (prior_bs * x[int(n / 4 + 0.5) - 1]) + 1.0 / x[-1]

    with np.errstate(divide="ignore", invalid="ignore"):
        k_b = np.mean(np.log1p(-b[:, None] * x[None, :]), axis=1)
        ll = n * (np.log(-b / k_b) - k_b - 1.0)
    ll = np.where(np.isfinite(ll), ll, -np.inf)
    w = 1.0 / np.sum(np.exp(ll[None, :] - ll[:, None]), axis=1)
    w = np.where(np.isfinite(w), w, 0.0)
    w = w / np.sum(w)
    b_post = np.sum(b * w)
    k_post = np.mean(np.log1p(-b_post * x))
    sigma = -k_post / b_post
    # weak prior regularization toward k=0.5 (arviz default)
    k_post = (n * k_post + 10.0 * 0.5) / (n + 10.0)
    return k_post, sigma


def _gpd_quantiles(p: np.ndarray, k: float, sigma: float) -> np.ndarray:
    """GPD inverse CDF: Q(p) = (sigma/k) * ((1-p)^{-k} - 1)."""
    if abs(k) < 1e-12:
        return -sigma * np.log1p(-p)
    return sigma * np.expm1(-k * np.log1p(-p)) / k


def _psis_smooth(log_ratios: np.ndarray):
    """Pareto-smooth one point's [S] log importance ratios; returns the
    smoothed log weights and the tail index k."""
    s = log_ratios.shape[0]
    lw = log_ratios - np.max(log_ratios)
    tail_len = max(int(np.ceil(min(0.2 * s, 3.0 * np.sqrt(s)))), 5)
    if tail_len >= s or not np.all(np.isfinite(lw)):
        return lw, np.inf
    order = np.argsort(lw)
    tail_idx = order[-tail_len:]
    cutoff = np.exp(lw[order[-tail_len - 1]])
    exp_tail = np.exp(lw[tail_idx]) - cutoff
    if np.all(exp_tail <= 0) or np.allclose(exp_tail, exp_tail[0]):
        return lw, 0.0
    k, sigma = _gpd_fit(exp_tail[exp_tail > 0])
    if not np.isfinite(k):
        return lw, np.inf
    # replace tail by expected GPD order statistics
    p = (np.arange(1, tail_len + 1) - 0.5) / tail_len
    smoothed = np.log(_gpd_quantiles(p, k, sigma) + cutoff)
    lw2 = lw.copy()
    lw2[tail_idx[np.argsort(lw[tail_idx])]] = smoothed
    lw2 = np.minimum(lw2, 0.0)  # truncate at the raw-weight max
    return lw2, k


def _psis_elpd(ll: np.ndarray):
    """[S, N] log-lik matrix -> ([N] elpd_loo contributions, [N] k-hats)."""
    s, n = ll.shape
    elpd = np.empty(n)
    ks = np.empty(n)
    for i in range(n):
        lw, k = _psis_smooth(-ll[:, i])
        lw = lw - _logsumexp(lw)
        elpd[i] = _logsumexp(lw + ll[:, i])
        ks[i] = k
    return elpd, ks


def _logsumexp(x):
    m = np.max(x)
    return m + np.log(np.sum(np.exp(x - m)))
