"""Particle Gibbs with ancestor sampling (PGAS): states and parameters of
state-space models.

Counterpart of ``brancher_tpu/inference/particle_gibbs.py`` (lines
41-238).  Each Gibbs iteration runs (a) a conditional particle filter
that keeps a reference trajectory alive in the last particle slot and
samples a new trajectory from the particle system, then (b) random-walk
Metropolis on theta against the complete-data log posterior given that
trajectory (Andrieu, Doucet and Holenstein 2010).  Ancestor sampling
(Lindsten, Jordan and Schön 2014) redraws the reference particle's
ancestor at every step with probability proportional to w_{t-1}^i
f(x_t^ref | x_{t-1}^i), which breaks path degeneracy.

The C chains advance together: ``make_ssm(theta [C, D])`` gives a
StateSpace over [C, P] blocks (``smc.py``), the sweep is a Python loop
over time over the whole block, and the backtrack is a loop of gathers.
Randomness, in order: the jitter of a 1-D theta0; the initial reference
rollouts; then per iteration the sweep (per step the resampling Gumbel
noise [C, P, P], the ancestor's [C, P], the proposals; at the end the
pick's [C, P]) and per MH step the proposal normals [C, D] and the
accept uniforms [C] (``smc.SMCRandom``; a test replays JAX's).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..config import resolve_device
from .smc import StateSpace, categorical, make_rng, take_particles

Tensor = torch.Tensor


class PGResult(NamedTuple):
    thetas: Tensor  # [C, S, D]
    trajectories: Tensor  # [C, S, T, *state] sampled state paths
    accept_rate: Tensor  # scalar (theta-MH acceptance)
    proposal_scale: Tensor  # [D]


def _pin(x: Tensor, ref: Tensor) -> Tensor:
    """x [C, P, *state] with its last particle set to ref [C, *state]."""
    return torch.cat([x[:, :-1], ref[:, None]], dim=1)


def _pgas_sweep(ssm: StateSpace, ys: Tensor, x_ref: Tensor, num_particles: int, rng,
                ancestor_sampling: bool = True) -> Tensor:
    """One conditional-SMC sweep for every chain: x_ref [C, T, *state] ->
    a newly sampled trajectory [C, T, *state]."""
    c, t_len = x_ref.shape[0], ys.shape[0]
    p = num_particles
    gen = rng.generator
    x = _pin(ssm.init_sample(gen, (c, p)), x_ref[:, 0])
    lw = ssm.obs_log_prob(ys[0], x, 0)
    xs, ancs = [x], []
    for t in range(1, t_len):
        # multinomial ancestors for the P - 1 free particles
        anc = categorical(lw.unsqueeze(-2), rng.gumbel((c, p, p)))
        if ancestor_sampling:
            # reference ancestor ~ w_{t-1}^i f(x_t^ref | x_{t-1}^i)
            ref_next = x_ref[:, t]
            trans_to_ref = ssm.trans_log_prob(ref_next[:, None], x, t)
            anc_ref = categorical(lw + trans_to_ref, rng.gumbel((c, p)))
        else:
            anc_ref = torch.full((c,), p - 1, dtype=anc.dtype, device=anc.device)
        anc = torch.cat([anc[:, :-1], anc_ref[:, None]], dim=1)
        x = _pin(ssm.trans_sample(gen, take_particles(x, anc), t), x_ref[:, t])
        lw = ssm.obs_log_prob(ys[t], x, t)
        xs.append(x)
        ancs.append(anc)
    # backtrack one path: j_T ~ Cat(w_T), j_{t-1} = anc_t[j_t]
    j = categorical(lw, rng.gumbel((c, p)))
    picks = [j]
    for anc in reversed(ancs):
        j = torch.gather(anc, 1, j[:, None])[:, 0]
        picks.append(j)
    js = torch.stack(picks[::-1], dim=1)  # [C, T]
    xs = torch.stack(xs, dim=1)  # [C, T, P, *state]
    return take_particles(xs, js[..., None])[:, :, 0]


def _complete_data_log_post(make_ssm, log_prior, theta: Tensor, traj: Tensor, ys: Tensor) -> Tensor:
    """log p(theta) + log p(x_{0:T-1}, y_{0:T-1} | theta) for every chain:
    theta [C, D], traj [C, T, *state] -> [C], the time terms summed at once."""
    ssm = make_ssm(theta)
    t_len = ys.shape[0]
    lp = log_prior(theta) + ssm.init_log_prob(traj[:, 0]) + ssm.obs_log_prob(ys[0], traj[:, 0], 0)
    # every t >= 1 at once: the callbacks are elementwise over leading axes,
    # with the chain axis first and time second (t is a tensor here)
    ts = torch.arange(1, t_len, device=traj.device)
    y_rest = ys[1:].reshape((1, t_len - 1) + ys.shape[1:])
    lp = lp + torch.sum(ssm.trans_log_prob(traj[:, 1:], traj[:, :-1], ts), dim=1)
    return lp + torch.sum(ssm.obs_log_prob(y_rest, traj[:, 1:], ts), dim=1)


def particle_gibbs_sample(make_ssm: Callable[[Tensor], StateSpace], ys,
                          log_prior: Callable[[Tensor], Tensor], theta0,
                          num_samples: int = 500, num_warmup: int = 300, num_particles: int = 64,
                          num_chains: int = 8, key=None, init_proposal_scale: float = 0.1,
                          target_accept: float = 0.44, ancestor_sampling: bool = True,
                          mh_steps_per_sweep: int = 2, device=None, rng=None) -> PGResult:
    """PGAS over (theta, x_{0:T-1}) on ``device`` (default
    ``config.device``); ``make_ssm`` and ``log_prior`` as in
    ``pmmh.pmmh_sample``."""
    dev = resolve_device(device)
    rng = make_rng(key, dev, rng)
    ys = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    theta = torch.atleast_1d(torch.as_tensor(theta0, dtype=torch.float32, device=dev))
    d = theta.shape[-1]
    if theta.dim() == 1:
        theta = theta[None, :] + 0.01 * rng.normal((num_chains, d))
    c, t_len = theta.shape[0], ys.shape[0]

    # initial references: one prior rollout per chain (a [C, 1] block)
    ssm = make_ssm(theta)
    x = ssm.init_sample(rng.generator, (c, 1))
    ref = [x]
    for t in range(1, t_len):
        x = ssm.trans_sample(rng.generator, x, t)
        ref.append(x)
    ref = torch.stack(ref, dim=1)[:, :, 0]

    log_scale = torch.full((d,), math.log(init_proposal_scale), device=dev)
    thetas, trajs, accs = [], [], []
    for it in range(num_warmup + num_samples):
        warm = it < num_warmup
        # (a) conditional SMC: a new trajectory given theta
        ref = _pgas_sweep(make_ssm(theta), ys, ref, num_particles, rng, ancestor_sampling)
        # (b) random-walk MH on theta given the trajectory
        lp = _complete_data_log_post(make_ssm, log_prior, theta, ref, ys)
        acc_sum = torch.zeros((), device=dev)
        for _ in range(mh_steps_per_sweep):
            prop = theta + torch.exp(log_scale)[None, :] * rng.normal(theta.shape)
            lp_new = _complete_data_log_post(make_ssm, log_prior, prop, ref, ys)
            log_ratio = lp_new - lp
            log_ratio = torch.where(torch.isnan(log_ratio),
                                    torch.full_like(log_ratio, -math.inf), log_ratio)
            acc = torch.log(rng.uniform((c,))) < log_ratio
            theta = torch.where(acc[:, None], prop, theta)
            lp = torch.where(acc, lp_new, lp)
            if warm:
                acc_rate = torch.mean(torch.clamp(torch.exp(log_ratio), max=1.0))
                log_scale = log_scale + 0.05 * (acc_rate - target_accept)
            acc_sum = acc_sum + acc.float().mean()
        if not warm:
            thetas.append(theta)
            trajs.append(ref)
            accs.append(acc_sum / mh_steps_per_sweep)
    return PGResult(
        thetas=torch.stack(thetas, dim=1) if thetas else theta.new_zeros((c, 0, d)),
        trajectories=(torch.stack(trajs, dim=1) if trajs
                      else ref.new_zeros((c, 0) + tuple(ref.shape[1:]))),
        accept_rate=(torch.stack(accs).mean() if accs else torch.tensor(math.nan, device=dev)),
        proposal_scale=torch.exp(log_scale),
    )


__all__ = ["PGResult", "particle_gibbs_sample"]
