"""Sampler diagnostics: ESS and split R-hat.

Counterpart of ``brancher_tpu/inference/diagnostics.py``:

  * on the host in numpy (lines 19-74 and 204-264): Geyer initial-
    monotone-sequence ESS from the FFT autocovariance, split R-hat, and the
    rank-normalized and folded R-hats of Vehtari et al. (2021); the samples
    move to the host once;
  * on the samples' device in torch (lines 97-201):
    ``effective_sample_size_device`` and
    ``potential_scale_reduction_device``.  The device ESS is the same
    estimator with the autocovariance taken directly at the first
    ``max_lag`` lags (no FFT), and a pessimistic tail where Geyer's
    positive sequence has not ended by then; only the [dim] results need
    to leave the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch


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


def _as_float(samples) -> torch.Tensor:
    x = torch.as_tensor(samples)
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    return x[None, :] if x.dim() == 1 else x


def effective_sample_size_device(samples, max_lag: int = 256) -> torch.Tensor:
    """ESS of [chains, draws, ...] samples, computed where they are.

    The estimator of :func:`effective_sample_size` with the autocovariance
    truncated at ``max_lag`` lags.  If Geyer's initial positive sequence
    has not ended by the last pair, the truncated sum would overstate the
    ESS, so the last pair is taken to persist to draws/2 pairs.  Returns a
    tensor of shape ``samples.shape[2:]`` on the samples' device.
    """
    x = _as_float(samples)
    event_shape = x.shape[2:]
    chains, draws = x.shape[0], x.shape[1]
    if draws < 2:
        return torch.full(event_shape, float("nan"), dtype=x.dtype, device=x.device)
    flat = x.reshape(chains, draws, -1)
    k = min(int(max_lag), draws - 1)
    xc = flat - flat.mean(dim=1, keepdim=True)
    acov = torch.stack([(xc[:, : draws - lag] * xc[:, lag:]).sum(dim=1) / draws
                        for lag in range(k)])  # [K, C, P]
    mean_acov = acov.mean(dim=1)  # [K, P]
    w = acov[0].mean(dim=0) * draws / (draws - 1.0)
    b_over_n = flat.mean(dim=1).var(dim=0) if chains > 1 else torch.zeros_like(w)
    var_plus = w * (draws - 1.0) / draws + b_over_n

    rho = 1.0 - (w[None, :] - mean_acov) / var_plus[None, :]
    rho[0] = 1.0
    k_half = k // 2
    p = rho[0: 2 * k_half: 2] + rho[1: 2 * k_half: 2]
    alive = torch.cumprod((p > 0.0).to(x.dtype), dim=0)
    p = torch.clamp(torch.cummin(p * alive, dim=0).values, min=0.0)
    tau = -1.0 + 2.0 * p.sum(dim=0)
    # the truncation guard: the last pair repeated to draws/2 pairs
    tau = torch.where(alive[-1] > 0.0, tau + 2.0 * p[-1] * (draws // 2 - k_half), tau)
    tau = torch.clamp(tau, min=1.0 / math.log10(float(draws * chains)))
    ess = torch.clamp(chains * draws / tau, max=float(chains * draws))
    return ess.reshape(event_shape)


def potential_scale_reduction_device(samples) -> torch.Tensor:
    """Split R-hat of [chains, draws, ...] samples, computed where they are."""
    x = _as_float(samples)
    event_shape = x.shape[2:]
    draws = x.shape[1]
    if draws < 4:
        return torch.full(event_shape, float("nan"), dtype=x.dtype, device=x.device)
    half = draws // 2
    split = torch.cat([x[:, :half], x[:, half: 2 * half]], dim=0)
    m, n = split.shape[0], split.shape[1]
    flat = split.reshape(m, n, -1)
    w = flat.var(dim=1).mean(dim=0)
    b = n * flat.mean(dim=1).var(dim=0)
    var_plus = (n - 1.0) / n * w + b / n
    return torch.sqrt(var_plus / w).reshape(event_shape)


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
