"""Particle-marginal Metropolis-Hastings: parameters of state-space models.

Counterpart of ``brancher_tpu/inference/pmmh.py`` (``pmmh_sample``, lines
27-287).  A random-walk Metropolis chain over theta whose likelihood is
the particle filter's unbiased estimate of p(y | theta) (Andrieu, Doucet
and Holenstein 2010: the chain targets the exact posterior despite the
noisy likelihood).  The C chains advance together: every iteration runs C
particle filters as one [C, P] block (``smc.particle_filter`` with
``batch_shape=(C,)``), and the proposal scale adapts during warmup by
Robbins-Monro toward 0.234 acceptance.

``make_ssm(theta [C, D])`` is called once per iteration with every
chain's theta and returns a StateSpace over [C, P] blocks (JAX calls it
once per chain, under ``vmap``); ``log_prior(theta [C, D]) -> [C]``.
Randomness, in order: the jitter of a 1-D theta0, the initial filters,
then per iteration the proposal normals [C, D], the filters and the
accept uniforms [C] (``smc.SMCRandom``; a test replays JAX's).

Sharded modes (``mesh=``, JAX lines 34-88 and 140-287; the SPMD
convention of ``parallel/mesh.py``: every rank calls ``pmmh_sample``
alike and gets the global result):

  * ``shard="chain"``: the chains split over the mesh's ``chain_axis``
    dimension; a rank's proposals, accepts and filters draw from the key's
    generator folded with its rank, and the Robbins-Monro accept rate is
    the mean over ranks;
  * ``shard="particle"``: each chain's particles split over the
    ``particle_axis`` dimension into island filters of P / n particles,
    whose estimates combine by log-mean-exp (a MAX and a SUM over the
    ranks; still unbiased).  Theta is replicated: the proposals and accept
    draws come from the replicated generator, so the accept decisions
    agree bit for bit on every rank, and only the islands' draws are
    folded with the rank;
  * ``shard="both"``: a 2-D mesh with both dimensions; the chains split
    over the chain dimension and each chain's particles over the particle
    dimension.  The island combine runs over the particle sub-group only,
    the accept-rate consensus over the chain sub-group only.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..config import resolve_device
from ..parallel.collectives import all_gather, fold_in, local_block, mesh_axis, pmax, pmean, psum
from .smc import SMCRandom, StateSpace, make_rng, particle_filter

Tensor = torch.Tensor


class PMMHResult(NamedTuple):
    thetas: Tensor  # [C, S, D]
    log_marginals: Tensor  # [C, S]
    accept_rate: Tensor  # scalar
    proposal_scale: Tensor  # [D]


def _pmmh_step(theta: Tensor, ll: Tensor, lp: Tensor, log_scale: Tensor, warm: bool,
               loglik: Callable[[Tensor], Tensor], log_prior: Callable[[Tensor], Tensor],
               rng, target_accept: float = 0.234, chain_axis=None):
    """One iteration for every chain: (theta, ll, lp, log_scale, accept).
    With ``chain_axis`` the accept rate is the mean over its ranks."""
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
        if chain_axis is not None:
            acc_rate = pmean(acc_rate, chain_axis)
        log_scale = log_scale + 0.05 * (acc_rate - target_accept)
    return theta, ll, lp, log_scale, accept


def pmmh_sample(make_ssm: Callable[[Tensor], StateSpace], ys, log_prior: Callable[[Tensor], Tensor],
                theta0, num_samples: int = 500, num_warmup: int = 300, num_particles: int = 256,
                num_chains: int = 8, key=None, init_proposal_scale: float = 0.1,
                target_accept: float = 0.234, ess_threshold: float = 0.5, mesh=None,
                chain_axis: str = "chain", shard: str = "chain", particle_axis: str = "particle",
                device=None, rng=None) -> PMMHResult:
    """PMMH on ``device`` (default ``config.device``, or the mesh's device
    type with ``mesh``).  theta0: [D] (the chains jitter around it) or
    [C, D].  ``mesh`` with ``shard`` "chain", "particle" or "both" selects
    a sharded mode (module docstring) over the mesh's ``chain_axis`` and
    ``particle_axis`` dimensions."""
    if mesh is not None and shard not in ("chain", "particle", "both"):
        raise ValueError(f"unknown shard mode {shard!r}")
    dev = resolve_device(mesh.device_type if device is None and mesh is not None else device)
    rng = make_rng(key, dev, rng)
    ys = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    theta = torch.atleast_1d(torch.as_tensor(theta0, dtype=torch.float32, device=dev))
    d = theta.shape[-1]
    if theta.dim() == 1:
        theta = theta[None, :] + 0.01 * rng.normal((num_chains, d))
    caxis = paxis = None
    if mesh is not None and shard in ("chain", "both"):
        caxis = mesh_axis(mesh, chain_axis)
        theta = local_block(theta, caxis, "num_chains")
    if mesh is not None and shard in ("particle", "both"):
        paxis = mesh_axis(mesh, particle_axis)
        if num_particles % paxis.size:
            raise ValueError(f"num_particles={num_particles} must divide over mesh axis "
                             f"{particle_axis!r} of size {paxis.size}")
    # a chain block draws its own numbers; an island its particles' too
    chain_rng = rng if caxis is None else SMCRandom(fold_in(rng.generator, caxis.index))
    filter_rng = (chain_rng if paxis is None
                  else SMCRandom(fold_in(chain_rng.generator, paxis.index)))
    n_part = num_particles if paxis is None else num_particles // paxis.size
    c = theta.shape[0]

    def loglik(th):
        ll = particle_filter(make_ssm(th), ys, n_part, ess_threshold=ess_threshold,
                             batch_shape=(c,), device=dev, rng=filter_rng).log_marginal
        if paxis is None:
            return ll
        m = pmax(ll, paxis)  # the islands' log-mean-exp
        return m + torch.log(psum(torch.exp(ll - m), paxis) / paxis.size)

    ll, lp = loglik(theta), log_prior(theta)
    log_scale = torch.full((d,), math.log(init_proposal_scale), device=dev)
    thetas, lls, accepts = [], [], []
    for t in range(num_warmup + num_samples):
        theta, ll, lp, log_scale, accept = _pmmh_step(
            theta, ll, lp, log_scale, t < num_warmup, loglik, log_prior, chain_rng,
            target_accept, caxis)
        if t >= num_warmup:
            thetas.append(theta)
            lls.append(ll)
            accepts.append(accept)
    if not thetas:
        c_all = c * (1 if caxis is None else caxis.size)
        return PMMHResult(theta.new_zeros((c_all, 0, d)), theta.new_zeros((c_all, 0)),
                          torch.tensor(math.nan, device=dev), torch.exp(log_scale))
    thetas, lls, accepts = (torch.stack(v, dim=1) for v in (thetas, lls, accepts))
    if caxis is not None:
        thetas, lls, accepts = (all_gather(v, caxis) for v in (thetas, lls, accepts))
    return PMMHResult(thetas=thetas, log_marginals=lls, accept_rate=accepts.float().mean(),
                      proposal_scale=torch.exp(log_scale))


__all__ = ["PMMHResult", "pmmh_sample"]
