"""Sampler diagnostics: ESS and split R-hat, on the host in numpy.

Counterpart of ``brancher_tpu/inference/diagnostics.py`` (lines 19-74
and 204-264): Geyer initial-monotone-sequence ESS from the FFT
autocovariance, split R-hat, and the rank-normalized and folded R-hats of
Vehtari et al. (2021).  The samples move to the host once; the device
variants (``effective_sample_size_device``,
``potential_scale_reduction_device``) are still to port (ROADMAP queue 1,
item 8).
"""
from __future__ import annotations

import numpy as np


def _autocovariance_fft(x: np.ndarray) -> np.ndarray:
    """Autocovariance along axis 1.  x: [chains, T, P] -> [chains, T, P]."""
    t = x.shape[1]
    xc = x - np.mean(x, axis=1, keepdims=True)
    n_fft = int(2 ** np.ceil(np.log2(2 * t)))
    f = np.fft.rfft(xc, n=n_fft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=n_fft, axis=1)[:, :t]
    return np.real(acov) / t


def effective_sample_size(samples) -> np.ndarray:
    """ESS of [chains, draws] or [chains, draws, ...] samples (per column).

    Mean-of-chain autocovariances with between-chain correction
    (BDA3 / Stan), Geyer initial positive + monotone sequence on paired
    sums.  Capped at chains*draws (the independent-sampling bound).
    """
    x = np.asarray(samples, dtype=np.float64)
    in_ndim = x.ndim
    if x.ndim == 1:
        x = x[None, :]
    chains, draws = x.shape[0], x.shape[1]
    if draws < 2:
        # Too few draws to estimate autocovariance (the draws-1 divisor
        # below would warn/blow up); report NaN explicitly.
        nan = np.full(x.shape[2:] if in_ndim > 2 else (), np.nan)
        return nan if in_ndim > 2 else np.squeeze(nan)
    flat = x.reshape(chains, draws, -1)

    acov = _autocovariance_fft(flat)  # [chains, T, P]
    mean_acov = np.mean(acov, axis=0)  # [T, P]
    chain_means = np.mean(flat, axis=1)  # [chains, P]
    w = np.mean(acov[:, 0, :], axis=0) * draws / (draws - 1.0)  # within var
    if chains > 1:
        b_over_n = np.var(chain_means, axis=0, ddof=1)
    else:
        b_over_n = np.zeros_like(w)
    var_plus = w * (draws - 1.0) / draws + b_over_n

    # rho_t = 1 - (W - mean autocov_t) / var_plus
    rho = 1.0 - (w[None, :] - mean_acov) / var_plus[None, :]
    rho[0] = 1.0

    # Geyer: paired sums P_k = rho_{2k} + rho_{2k+1}
    t_half = draws // 2
    p = rho[0 : 2 * t_half : 2] + rho[1 : 2 * t_half : 2]  # [t_half, P]
    # initial positive sequence: zero out after first negative
    p = p * np.cumprod(p > 0.0, axis=0)
    # initial monotone: running minimum
    p = np.maximum(np.minimum.accumulate(p, axis=0), 0.0)
    tau = -1.0 + 2.0 * np.sum(p, axis=0)
    tau = np.maximum(tau, 1.0 / np.log10(float(draws * chains)))
    ess = chains * draws / tau
    ess = np.minimum(ess, float(chains * draws))
    return ess.reshape(x.shape[2:]) if in_ndim > 2 else np.squeeze(ess)


def potential_scale_reduction(samples) -> np.ndarray:
    """Split R-hat of [chains, draws, ...] samples."""
    x = np.asarray(samples, dtype=np.float64)
    in_ndim = x.ndim
    if x.ndim == 1:
        x = x[None, :]
    draws = x.shape[1]
    if draws < 4:
        # Split halves need >= 2 draws each for the ddof=1 variances;
        # report NaN explicitly instead of warning.
        nan = np.full(x.shape[2:] if in_ndim > 2 else (), np.nan)
        return nan if in_ndim > 2 else np.squeeze(nan)
    half = draws // 2
    split = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)
    m, n = split.shape[0], split.shape[1]
    flat = split.reshape(m, n, -1)
    chain_means = np.mean(flat, axis=1)
    chain_vars = np.var(flat, axis=1, ddof=1)
    w = np.mean(chain_vars, axis=0)
    b = n * np.var(chain_means, axis=0, ddof=1)
    var_plus = (n - 1.0) / n * w + b / n
    rhat = np.sqrt(var_plus / w)
    return rhat.reshape(x.shape[2:]) if in_ndim > 2 else np.squeeze(rhat)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Average-rank normal-quantile transform over ALL draws (Vehtari et
    al. 2021 §3): pooled fractional ranks -> Phi^{-1}."""
    from scipy.special import ndtri

    chains, draws = x.shape[0], x.shape[1]
    flat = x.reshape(chains * draws, -1)
    order = np.argsort(flat, axis=0)
    ranks = np.empty_like(flat)
    rng_idx = np.arange(flat.shape[0])[:, None]
    np.put_along_axis(ranks, order, rng_idx.astype(flat.dtype) + 1.0, axis=0)
    frac = (ranks - 0.375) / (flat.shape[0] + 0.25)  # Blom offsets
    return ndtri(frac).reshape(x.shape)


def rank_normalized_rhat(samples) -> np.ndarray:
    """Rank-normalized split R-hat (Vehtari, Gelman, Simpson, Carpenter,
    Bürkner 2021): robust to heavy tails and location-invariant — the
    modern default convergence diagnostic (ROADMAP r1 #10)."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    return potential_scale_reduction(_rank_normalize(x))


def folded_rhat(samples) -> np.ndarray:
    """Rank-normalized split R-hat of |x - median|: detects chains that
    agree in location but differ in SCALE (ibid. §3.2)."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    folded = np.abs(x - np.median(x, axis=(0, 1), keepdims=True))
    return potential_scale_reduction(_rank_normalize(folded))


def max_rhat(samples) -> np.ndarray:
    """max(rank-normalized, folded) — the value to threshold (< 1.01)."""
    return np.maximum(rank_normalized_rhat(samples), folded_rhat(samples))
