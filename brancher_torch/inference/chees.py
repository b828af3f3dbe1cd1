"""ChEES-HMC: adaptive-trajectory-length HMC without tree building.

Counterpart of ``brancher_tpu/inference/chees.py`` (``ChEESHMC``,
``ChEESResult``, ``chees_log_traj_grad``, ``_halton`` and ``chees_hmc``,
lines 36-340).  Cross-Chain Expected Squared Jump Distance adaptation
(Hoffman, Radul & Sountsov 2021): one trajectory length shared by all
chains, ascended in log space by Adam during warmup on the per-chain
estimator jump * <z' - m, v'>, and jittered by a Halton sequence.

Every array is chain-batched [C, d]; the step count of a transition is
ceil(t_jit / eps), computed on the device.  The fused leapfrog (K5)
reads it there; the loop path reads it on the host (one sync per
transition).  Randomness comes from a source with the methods of
``inference.hmc.TorchHMCRandom`` (momenta and accept uniforms), so a
test can replay the JAX stream (``split(k, 2)``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .adaptation import build_warmup_schedule, da_init, da_restart, da_update, diag_mass_update
from .hmc import VG, TorchHMCRandom, loop_leapfrog

Tensor = torch.Tensor


class ChEESResult(NamedTuple):
    samples: Tensor  # [C, S, d]
    accept_prob: Tensor  # [C, S]
    step_size: Tensor
    trajectory_length: Tensor
    inv_mass: Tensor
    num_leapfrog: Tensor  # [S] shared leapfrog steps per draw
    warmup_leapfrog: Tensor  # 0-d: total leapfrog steps during warmup
    diverging: Tensor  # [C, S] energy error > max_delta_energy (or non-finite)
    host_syncs: int  # device->host syncs of the whole run
    used_leapfrog_fn: bool  # the transitions ran leapfrog_fn (not under dense mass)


class ChEESHMC:
    """Kernel config for mcmc.sample(chain_method='vectorized')."""

    def __init__(self, target_accept: float = 0.8, init_trajectory_length: float = 1.0,
                 max_leapfrog: int = 256, adam_lr: float = 0.025, mass: str = "diag",
                 max_delta_energy: float = 1000.0):
        self.target_accept = target_accept
        self.init_trajectory_length = init_trajectory_length
        self.max_leapfrog = max_leapfrog
        self.adam_lr = adam_lr
        self.mass = mass
        self.max_delta_energy = max_delta_energy


def chees_log_traj_grad(z: Tensor, z1: Tensor, v1: Tensor, accept: Tensor,
                        accept_prob: Tensor, t_jit) -> Tensor:
    """d(ChEES)/d(log T) estimator at the jittered length t = u*T:
    accept-weighted cross-chain mean of jump * <z' - m, v'>, times t.
    Non-finite positions (divergent chains, zero accept weight) are kept
    out of the mean."""
    safe_z1 = torch.where(torch.isfinite(z1), z1, 0.0)
    safe_v1 = torch.where(torch.isfinite(v1), v1, 0.0)
    m = torch.mean(torch.where(accept[:, None], safe_z1, z), dim=0)
    dz1 = safe_z1 - m[None, :]
    dz0 = z - m[None, :]
    jump = torch.sum(dz1 * dz1, -1) - torch.sum(dz0 * dz0, -1)
    g_c = jump * torch.sum(dz1 * safe_v1, -1)
    g_c = torch.where(torch.isfinite(g_c), g_c, 0.0)
    num = torch.mean(g_c * accept_prob)
    den = torch.mean(accept_prob)
    return num / torch.clamp(den, min=1e-10) * t_jit


def _halton(i: int, base: int = 2) -> float:
    """Member i of the Halton sequence in (0, 1), in float32 arithmetic
    (30 digits, as the JAX loop)."""
    f, r, x = np.float32(0.0), np.float32(1.0), i + 1
    for _ in range(30):
        r = np.float32(r / np.float32(base))
        f = np.float32(f + r * np.float32(x % base))
        x //= base
    return float(f)


def chees_hmc(
    value_and_grad_fn: VG,
    z0: Tensor,
    num_warmup: int,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    init_trajectory_length: float = 1.0,
    max_leapfrog: int = 256,
    adam_lr: float = 0.025,
    inv_mass0: Optional[Tensor] = None,
    mass: str = "diag",
    leapfrog_fn=None,
    max_delta_energy: float = 1000.0,
    rng=None,
) -> ChEESResult:
    """value_and_grad_fn: [C,d] -> ([C] log posterior, [C,d] grad).

    mass: "diag" or "dense".  Dense adapts the full covariance as inverse
    mass; momenta are drawn from N(0, Sigma^-1) by a triangular solve and
    the drift is a [C,d]x[d,d] product.  The fused leapfrog supports
    diagonal mass only, so ``leapfrog_fn`` is dropped under dense mass,
    and the energy error is then checked at the endpoint only.
    """
    if mass not in ("diag", "dense"):
        raise ValueError(f"unknown mass type {mass!r}")
    diag = mass == "diag"
    if leapfrog_fn is not None and not diag:
        leapfrog_fn = None
    c, d = z0.shape
    dtype, dev = z0.dtype, z0.device
    rng = TorchHMCRandom(generator) if rng is None else rng

    def sample_momentum(z, inv_mass, chol):
        eps_n = rng.momentum(z)
        if diag:
            return eps_n / torch.sqrt(inv_mass)[None, :]
        # Sigma = chol chol^T; r ~ N(0, Sigma^-1) => r = chol^-T eps
        return torch.linalg.solve_triangular(chol.T, eps_n.T, upper=True).T

    def velocity(r, inv_mass):
        return r * inv_mass[None, :] if diag else r @ inv_mass

    def kinetic(r, inv_mass):
        return 0.5 * torch.sum(r * velocity(r, inv_mass), -1)

    def one_step(z, val, grad, eps, traj, inv_mass, chol, step_idx):
        r0 = sample_momentum(z, inv_mass, chol)
        h0 = -val + kinetic(r0, inv_mass)
        t_jit = traj * _halton(step_idx)
        n_steps = torch.clamp(torch.ceil(t_jit / eps).to(torch.int32), 1, max_leapfrog)
        syncs = 0
        if leapfrog_fn is not None:
            z1, r1, val1, grad1 = leapfrog_fn(z, r0, grad, eps, inv_mass, n_steps)
            syncs += getattr(leapfrog_fn, "host_syncs_per_call", 0)
            div_traj = torch.zeros((c,), dtype=torch.bool, device=dev)  # endpoint below
        else:
            z1, r1, val1, grad1, div_traj = loop_leapfrog(
                value_and_grad_fn, z, r0, grad, eps, inv_mass, int(n_steps),
                h0=h0 if diag else None, kinetic=kinetic,
                velocity=lambda rr: velocity(rr, inv_mass),
                max_delta_energy=max_delta_energy)
            syncs += 1
        h1 = -val1 + kinetic(r1, inv_mass)
        delta = torch.where(torch.isnan(h1), -torch.inf, h0 - h1)
        diverging = div_traj | (delta < -max_delta_energy)
        accept_prob = torch.clamp(torch.exp(torch.clamp(delta, max=0.0)), max=1.0)
        accept = rng.accept(c, val) < accept_prob
        chees_grad = chees_log_traj_grad(z, z1, velocity(r1, inv_mass), accept,
                                          accept_prob, t_jit)
        z = torch.where(accept[:, None], z1, z)
        val = torch.where(accept, val1, val)
        grad = torch.where(accept[:, None], grad1, grad)
        return z, val, grad, accept_prob, chees_grad, n_steps, diverging, syncs

    val, grad = value_and_grad_fn(z0)
    z = z0
    in_slow, window_end = build_warmup_schedule(num_warmup)

    da = da_init(torch.tensor(init_step_size, dtype=dtype, device=dev))
    if inv_mass0 is not None:
        inv_mass = torch.as_tensor(inv_mass0, dtype=dtype, device=dev)
    elif diag:
        inv_mass = torch.ones((d,), dtype=dtype, device=dev)
    else:
        inv_mass = torch.eye(d, dtype=dtype, device=dev)
    chol = None if diag else torch.eye(d, dtype=dtype, device=dev)
    s1 = torch.zeros((d,), dtype=dtype, device=dev)
    s2 = torch.zeros((d,) if diag else (d, d), dtype=dtype, device=dev)
    n_acc = 0
    log_traj = torch.log(torch.tensor(init_trajectory_length, dtype=dtype, device=dev))
    adam_m = torch.zeros((), dtype=dtype, device=dev)
    adam_v = torch.zeros_like(adam_m)
    lf_total = torch.zeros((), dtype=torch.int32, device=dev)
    syncs = 0
    for i in range(num_warmup):
        eps = torch.exp(da.log_step)
        z, val, grad, ap, g, n_steps, _, k = one_step(
            z, val, grad, eps, torch.exp(log_traj), inv_mass, chol, i)
        syncs += k
        lf_total = lf_total + n_steps
        da = da_update(da, torch.mean(ap), target_accept=target_accept)
        # Adam ascent on log trajectory length
        t = float(i + 1)
        adam_m = 0.9 * adam_m + 0.1 * g
        adam_v = 0.999 * adam_v + 0.001 * g * g
        mhat = adam_m / (1.0 - np.float32(0.9) ** np.float32(t))
        vhat = adam_v / (1.0 - np.float32(0.999) ** np.float32(t))
        log_traj = log_traj + adam_lr * mhat / (torch.sqrt(vhat) + 1e-8)
        # keep the trajectory at most max_leapfrog steps at the current eps
        log_traj = torch.minimum(log_traj, torch.log(eps * max_leapfrog))
        if in_slow[i]:
            s1 = s1 + torch.sum(z, 0)
            s2 = s2 + (torch.sum(z * z, 0) if diag else z.T @ z)
            n_acc += c
        if window_end[i]:
            if diag:
                inv_mass = diag_mass_update(s1, s2, n_acc)
            else:
                ng = float(n_acc)
                mean = s1 / max(ng, 1.0)
                shrink = ng / (ng + 5.0)
                cov = s2 / max(ng, 1.0) - torch.outer(mean, mean)
                cov = shrink * cov + 1e-3 * (1.0 - shrink) * torch.eye(d, dtype=dtype, device=dev)
                inv_mass, chol = cov, torch.linalg.cholesky(cov)
            s1, s2, n_acc = torch.zeros_like(s1), torch.zeros_like(s2), 0
            da = da_restart(da)
    eps_final = (torch.exp(da.log_step_avg) if num_warmup > 0
                 else torch.tensor(init_step_size, dtype=dtype, device=dev))
    traj_final = torch.exp(log_traj)

    zs = torch.empty((num_samples, c, d), dtype=dtype, device=dev)
    aps = torch.empty((num_samples, c), dtype=dtype, device=dev)
    dvgs = torch.empty((num_samples, c), dtype=torch.bool, device=dev)
    n_leaps = torch.empty((num_samples,), dtype=torch.int32, device=dev)
    for s in range(num_samples):
        z, val, grad, ap, _, n_steps, dv, k = one_step(
            z, val, grad, eps_final, traj_final, inv_mass, chol, num_warmup + s)
        zs[s], aps[s], dvgs[s], n_leaps[s] = z, ap, dv, n_steps
        syncs += k
    return ChEESResult(
        samples=zs.transpose(0, 1),
        accept_prob=aps.transpose(0, 1),
        step_size=eps_final,
        trajectory_length=traj_final,
        inv_mass=inv_mass,
        num_leapfrog=n_leaps,
        warmup_leapfrog=lf_total,
        diverging=dvgs.transpose(0, 1),
        host_syncs=syncs,
        used_leapfrog_fn=leapfrog_fn is not None,
    )
