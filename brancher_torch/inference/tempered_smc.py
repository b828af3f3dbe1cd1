"""Adaptive tempered SMC sampler for static models.

Counterpart of ``brancher_tpu/inference/tempered_smc.py`` (lines 43-186):
SMC as a posterior sampler over any ProbabilisticModel.  The targets are
prior(z) lik(z)^beta with 0 = beta_0 < ... < beta_K = 1; each increment is
the largest beta whose incremental-weight ESS stays at a target fraction,
found by a fixed number of bisection steps on the device.  Between
temperatures: systematic resampling and a few MH-corrected HMC steps on
the tempered density, with the [P, d] particle block as the chain block
and gradients from ``torch.func``.  The loop over stages reads beta back
once a stage to decide whether to go on.

Randomness: each stage draws its resampling uniform, then for every HMC
step the momenta [P, d] and the accept uniforms [P], from a source with
the methods of ``smc.SMCRandom`` (a test replays JAX's numbers).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..config import resolve_device
from .smc import _ess, make_rng, systematic_resample_indices

Tensor = torch.Tensor


class TemperedSMCResult(NamedTuple):
    particles: Tensor  # [P, d] unconstrained
    log_evidence: Tensor
    betas: Tensor  # [max_stages + 1] temperature ladder (padded with 1.0)
    num_stages: int
    ess_history: Tensor  # [max_stages]


def next_beta(beta: Tensor, log_lik: Tensor, ess_target: float = 0.5,
              bisection_iters: int = 26) -> Tensor:
    """The largest beta' in (beta, 1] whose incremental weights
    (beta' - beta) log_lik keep an ESS of at least ess_target * P: 1 when
    it does at 1, else ``bisection_iters`` halvings of [beta, 1]."""
    p = log_lik.shape[0]
    lo, hi = beta, torch.ones_like(beta)
    for _ in range(bisection_iters):
        mid = 0.5 * (lo + hi)
        ok = _ess((mid - beta) * log_lik) >= ess_target * p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    full_ok = _ess((1.0 - beta) * log_lik) >= ess_target * p
    return torch.where(full_ok, torch.ones_like(lo), lo)


def hmc_rejuvenate(log_prior_fn, log_lik_fn, z: Tensor, beta: Tensor, rng,
                   steps: int = 3, step_size: float = 0.2, num_leapfrog: int = 8) -> Tensor:
    """``steps`` MH-corrected HMC steps (unit mass, ``num_leapfrog`` steps
    of ``step_size``) on prior(z) lik(z)^beta for every row of z [P, d]."""
    def logpost_row(zrow):
        zz = zrow[None, :]
        return (log_prior_fn(zz) + beta * log_lik_fn(zz))[0]

    gv = torch.func.vmap(torch.func.grad_and_value(logpost_row))

    def vg(zz):
        g, v = gv(zz)
        return v.detach(), g.detach()

    val, grad = vg(z)
    for _ in range(steps):
        r0 = rng.normal(z.shape)
        h0 = -val + 0.5 * torch.sum(r0 * r0, -1)
        z1, r1, val1, grad1 = z, r0, val, grad
        for _ in range(num_leapfrog):
            r1 = r1 + 0.5 * step_size * grad1
            z1 = z1 + step_size * r1
            val1, grad1 = vg(z1)
            r1 = r1 + 0.5 * step_size * grad1
        h1 = -val1 + 0.5 * torch.sum(r1 * r1, -1)
        delta = torch.where(torch.isnan(h1), torch.full_like(h1, -math.inf), h0 - h1)
        accept = rng.uniform((z.shape[0],)) < torch.exp(torch.clamp(delta, max=0.0))
        z = torch.where(accept[:, None], z1, z)
        val = torch.where(accept, val1, val)
        grad = torch.where(accept[:, None], grad1, grad)
    return z


def tempered_smc(log_prior_fn: Callable[[Tensor], Tensor], log_lik_fn: Callable[[Tensor], Tensor],
                 z0: Tensor, key=None, ess_target: float = 0.5, rejuvenation_steps: int = 3,
                 hmc_step_size: float = 0.2, hmc_num_leapfrog: int = 8, max_stages: int = 50,
                 bisection_iters: int = 26, rng=None) -> TemperedSMCResult:
    """Tempered SMC from prior draws z0 [P, d] on their device;
    ``log_prior_fn`` and ``log_lik_fn`` map [P, d] to [P] (and must be
    ``torch.func`` transformable: the rejuvenation differentiates them
    row by row)."""
    p, _ = z0.shape
    rng = make_rng(key, z0.device, rng)
    dtype = z0.dtype
    z = z0
    beta = torch.zeros((), dtype=dtype, device=z0.device)
    log_ev = torch.zeros((), dtype=dtype, device=z0.device)
    betas = torch.ones((max_stages + 1,), dtype=dtype, device=z0.device)
    betas[0] = 0.0
    esss = torch.zeros((max_stages,), dtype=dtype, device=z0.device)
    stage = 0
    while stage < max_stages and float(beta) < 1.0:
        with torch.no_grad():
            log_lik = log_lik_fn(z)
        beta_new = next_beta(beta, log_lik, ess_target, bisection_iters)
        logw = (beta_new - beta) * log_lik
        # evidence increment: log mean of the incremental weights
        log_ev = log_ev + torch.logsumexp(logw, 0) - math.log(float(p))
        esss[stage] = _ess(logw)
        idx = systematic_resample_indices(None, logw, uniform=rng.uniform(()))
        z = hmc_rejuvenate(log_prior_fn, log_lik_fn, z[idx], beta_new, rng,
                           rejuvenation_steps, hmc_step_size, hmc_num_leapfrog)
        betas[stage + 1] = beta_new
        beta = beta_new
        stage += 1
    return TemperedSMCResult(z, log_ev, betas, stage, esss)


def smc_posterior_sample(model, num_particles: int = 1024, key=None, given=None, params=None,
                         device=None, rng=None, **smc_kwargs):
    """Tempered-SMC posterior sampling on a ProbabilisticModel (or a
    CompiledModel) on ``device`` (default ``config.device``): prior draws
    through the compiled model's walk, unconstrained, tempered, and mapped
    back.  Returns ({latent: [P, ...]} constrained, TemperedSMCResult)."""
    from ..compiler import CompiledModel

    comp = model if isinstance(model, CompiledModel) else model.compiled(resolve_device(device))
    rng = make_rng(key, comp.device, rng)
    if params is None:
        params = comp.initial_params

    def parts(zrow):
        return comp.log_density_z_parts(params, comp.unravel_z(zrow), given)

    log_prior_fn = torch.func.vmap(lambda zr: parts(zr)[0])
    log_lik_fn = torch.func.vmap(lambda zr: parts(zr)[1])
    names = comp.continuous_latent_names
    with torch.no_grad():
        draws = comp.sample(params, rng.generator, num_particles, given)
        z_tree = torch.func.vmap(lambda vals: comp.unconstrain(params, vals))(
            {n: draws[n] for n in names})
        z0 = comp.ravel_z(z_tree).to(torch.float32).contiguous()
    res = tempered_smc(log_prior_fn, log_lik_fn, z0, rng=rng, **smc_kwargs)
    with torch.no_grad():
        constrained = torch.func.vmap(
            lambda zr: {n: comp.constrain(params, comp.unravel_z(zr), given)[n] for n in names}
        )(res.particles)
    return constrained, res


__all__ = ["TemperedSMCResult", "next_beta", "hmc_rejuvenate", "tempered_smc",
           "smc_posterior_sample"]
