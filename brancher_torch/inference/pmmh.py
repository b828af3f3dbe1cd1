"""Particle-marginal Metropolis-Hastings: parameters of state-space models.

Counterpart of ``brancher_tpu/inference/pmmh.py`` without the sharded
modes (``pmmh_sample``, lines 27-165).  A random-walk Metropolis chain
over theta whose likelihood is the particle filter's unbiased estimate of
p(y | theta) (Andrieu, Doucet and Holenstein 2010: the chain targets the
exact posterior despite the noisy likelihood).  The C chains advance
together: every iteration runs C particle filters as one [C, P] block
(``smc.particle_filter`` with ``batch_shape=(C,)``), and the proposal
scale adapts during warmup by Robbins-Monro toward 0.234 acceptance.

``make_ssm(theta [C, D])`` is called once per iteration with every
chain's theta and returns a StateSpace over [C, P] blocks (JAX calls it
once per chain, under ``vmap``); ``log_prior(theta [C, D]) -> [C]``.
Randomness, in order: the jitter of a 1-D theta0, the initial filters,
then per iteration the proposal normals [C, D], the filters and the
accept uniforms [C] (``smc.SMCRandom``; a test replays JAX's).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..config import resolve_device
from .smc import StateSpace, make_rng, particle_filter, refuse_sharding

Tensor = torch.Tensor


class PMMHResult(NamedTuple):
    thetas: Tensor  # [C, S, D]
    log_marginals: Tensor  # [C, S]
    accept_rate: Tensor  # scalar
    proposal_scale: Tensor  # [D]


def _pmmh_step(theta: Tensor, ll: Tensor, lp: Tensor, log_scale: Tensor, warm: bool,
               loglik: Callable[[Tensor], Tensor], log_prior: Callable[[Tensor], Tensor],
               rng, target_accept: float = 0.234):
    """One iteration for every chain: (theta, ll, lp, log_scale, accept)."""
    prop = theta + torch.exp(log_scale)[None, :] * rng.normal(theta.shape)
    lp_new = log_prior(prop)
    ll_new = loglik(prop)
    log_ratio = (ll_new + lp_new) - (ll + lp)
    log_ratio = torch.where(torch.isnan(log_ratio), torch.full_like(log_ratio, -math.inf),
                            log_ratio)
    accept = torch.log(rng.uniform((theta.shape[0],))) < log_ratio
    theta = torch.where(accept[:, None], prop, theta)
    ll = torch.where(accept, ll_new, ll)
    lp = torch.where(accept, lp_new, lp)
    if warm:  # Robbins-Monro on the mean accept probability, warmup only
        acc_rate = torch.mean(torch.clamp(torch.exp(log_ratio), max=1.0))
        log_scale = log_scale + 0.05 * (acc_rate - target_accept)
    return theta, ll, lp, log_scale, accept


def pmmh_sample(make_ssm: Callable[[Tensor], StateSpace], ys, log_prior: Callable[[Tensor], Tensor],
                theta0, num_samples: int = 500, num_warmup: int = 300, num_particles: int = 256,
                num_chains: int = 8, key=None, init_proposal_scale: float = 0.1,
                target_accept: float = 0.234, ess_threshold: float = 0.5, mesh=None,
                chain_axis: str = "chain", shard: str = "chain", particle_axis: str = "particle",
                device=None, rng=None) -> PMMHResult:
    """PMMH on ``device`` (default ``config.device``).  theta0: [D] (the
    chains jitter around it) or [C, D].  ``mesh``, ``chain_axis``,
    ``shard`` and ``particle_axis`` select the JAX package's sharded
    modes, which are not ported: setting them raises (ROADMAP queue 1,
    item 15)."""
    refuse_sharding(mesh, chain_axis=(chain_axis, "chain"), shard=(shard, "chain"),
                    particle_axis=(particle_axis, "particle"))
    dev = resolve_device(device)
    rng = make_rng(key, dev, rng)
    ys = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    theta = torch.atleast_1d(torch.as_tensor(theta0, dtype=torch.float32, device=dev))
    d = theta.shape[-1]
    if theta.dim() == 1:
        theta = theta[None, :] + 0.01 * rng.normal((num_chains, d))
    c = theta.shape[0]

    def loglik(th):
        return particle_filter(make_ssm(th), ys, num_particles, ess_threshold=ess_threshold,
                               batch_shape=(c,), device=dev, rng=rng).log_marginal

    ll, lp = loglik(theta), log_prior(theta)
    log_scale = torch.full((d,), math.log(init_proposal_scale), device=dev)
    thetas, lls, accepts = [], [], []
    for t in range(num_warmup + num_samples):
        theta, ll, lp, log_scale, accept = _pmmh_step(
            theta, ll, lp, log_scale, t < num_warmup, loglik, log_prior, rng, target_accept)
        if t >= num_warmup:
            thetas.append(theta)
            lls.append(ll)
            accepts.append(accept)
    return PMMHResult(
        thetas=torch.stack(thetas, dim=1) if thetas else theta.new_zeros((c, 0, d)),
        log_marginals=torch.stack(lls, dim=1) if lls else theta.new_zeros((c, 0)),
        accept_rate=(torch.stack(accepts).float().mean() if accepts
                     else torch.tensor(math.nan, device=dev)),
        proposal_scale=torch.exp(log_scale),
    )


__all__ = ["PMMHResult", "pmmh_sample"]
