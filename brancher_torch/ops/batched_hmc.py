"""Chain-batched HMC: every array carries the chain axis explicitly
([C, d] positions and momenta), and all chains advance in lockstep.

Counterpart of ``brancher_tpu/ops/batched_hmc.py`` (``BatchedHMCResult``
and ``hmc_batched``, lines 27-171).  Adaptation is the same consensus
scheme as vectorized NUTS: one dual-averaged step size driven by the
mean accept probability over chains, and one diagonal mass from
cross-chain moments at each window end.

Two integrator paths, as in the JAX package:

  * no ``leapfrog_fn``: a Python loop of ``value_and_grad_fn`` calls,
    with the energy error checked at every step (NUTS-parity
    divergences).  The loop needs the step count on the host: one sync
    per transition when the count is jittered;
  * ``leapfrog_fn`` (``ops.leapfrog``): the whole trajectory in one call,
    divergence checked at the endpoint only.  The fused kernel (K5)
    reads the step count and the step size from device memory, so a
    transition needs no host sync.

Randomness is injectable: a transition reads its momenta, its accept
uniforms and its jittered step count from a source with the methods of
``inference.hmc.TorchHMCRandom``, so a test can replay the JAX stream
(``split(k, 3)`` into momentum, accept and length keys).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..inference.adaptation import (
    build_warmup_schedule, da_init, da_restart, da_update, diag_mass_update,
)
from ..inference.hmc import TorchHMCRandom, kinetic_energy, loop_leapfrog

Tensor = torch.Tensor
VG = Callable[[Tensor], Tuple[Tensor, Tensor]]


class BatchedHMCResult(NamedTuple):
    samples: Tensor  # [C, S, d]
    accept_prob: Tensor  # [C, S]
    step_size: Tensor
    inv_mass: Tensor
    diverging: Tensor  # [C, S] energy error > max_delta_energy (or non-finite)
    host_syncs: int  # device->host syncs of the whole run
    used_leapfrog_fn: bool  # the transitions ran leapfrog_fn


def hmc_transition(value_and_grad_fn: VG, z: Tensor, val: Tensor, grad: Tensor,
                   eps: Tensor, inv_mass: Tensor, rng, num_integration_steps: int,
                   jitter_steps: bool = True, leapfrog_fn=None,
                   max_delta_energy: float = 1000.0):
    """One HMC draw for all chains.  Returns (z, val, grad, accept_prob,
    diverging, host_syncs)."""
    c, _ = z.shape
    r0 = rng.momentum(z) / torch.sqrt(inv_mass)[None, :]
    h0 = -val + kinetic_energy(r0, inv_mass)
    n_steps: Union[int, Tensor] = (rng.num_steps(num_integration_steps, z.device)
                                   if jitter_steps else num_integration_steps)
    syncs = 0
    if leapfrog_fn is not None:
        z1, r1, val1, grad1 = leapfrog_fn(z, r0, grad, eps, inv_mass, n_steps)
        if isinstance(n_steps, Tensor):  # K5 reads it on the device, a loop on the host
            syncs += getattr(leapfrog_fn, "host_syncs_per_call", 0)
        div_traj = torch.zeros((c,), dtype=torch.bool, device=z.device)  # endpoint below
    else:
        if isinstance(n_steps, Tensor):
            n_steps, syncs = int(n_steps), syncs + 1
        z1, r1, val1, grad1, div_traj = loop_leapfrog(
            value_and_grad_fn, z, r0, grad, eps, inv_mass, n_steps, h0=h0,
            max_delta_energy=max_delta_energy)
    h1 = -val1 + kinetic_energy(r1, inv_mass)
    delta = h0 - h1
    delta = torch.where(torch.isnan(delta), -torch.inf, delta)
    diverging = div_traj | (delta < -max_delta_energy)
    accept_prob = torch.clamp(torch.exp(torch.clamp(delta, max=0.0)), max=1.0)
    accept = rng.accept(c, val) < accept_prob
    z = torch.where(accept[:, None], z1, z)
    val = torch.where(accept, val1, val)
    grad = torch.where(accept[:, None], grad1, grad)
    return z, val, grad, accept_prob, diverging, syncs


def hmc_batched(
    value_and_grad_fn: VG,
    z0: Tensor,
    num_warmup: int,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    num_integration_steps: int = 16,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    jitter_steps: bool = True,
    inv_mass0: Optional[Tensor] = None,
    leapfrog_fn=None,
    max_delta_energy: float = 1000.0,
    rng=None,
) -> BatchedHMCResult:
    """value_and_grad_fn: z [C,d] -> (log posterior [C], grad [C,d]).

    leapfrog_fn: optional multi-step integrator
    (z, r, grad, eps, inv_mass, n_steps) -> (z1, r1, val1, grad1), e.g.
    the fused kernel K5 (``ops.leapfrog``).
    """
    c, d = z0.shape
    dtype, dev = z0.dtype, z0.device
    rng = TorchHMCRandom(generator) if rng is None else rng
    val, grad = value_and_grad_fn(z0)
    z = z0
    in_slow, window_end = build_warmup_schedule(num_warmup)

    def step(z, val, grad, eps, inv_mass):
        return hmc_transition(value_and_grad_fn, z, val, grad, eps, inv_mass, rng,
                              num_integration_steps, jitter_steps, leapfrog_fn,
                              max_delta_energy)

    da = da_init(torch.tensor(init_step_size, dtype=dtype, device=dev))
    inv_mass = (torch.ones((d,), dtype=dtype, device=dev) if inv_mass0 is None
                else torch.as_tensor(inv_mass0, dtype=dtype, device=dev))
    s1 = torch.zeros((d,), dtype=dtype, device=dev)
    s2 = torch.zeros_like(s1)
    n_acc = 0
    syncs = 0
    for i in range(num_warmup):
        z, val, grad, ap, _, k = step(z, val, grad, torch.exp(da.log_step), inv_mass)
        syncs += k
        da = da_update(da, torch.mean(ap), target_accept=target_accept)
        if in_slow[i]:
            s1 = s1 + torch.sum(z, dim=0)
            s2 = s2 + torch.sum(z * z, dim=0)
            n_acc += c
        if window_end[i]:
            inv_mass = diag_mass_update(s1, s2, n_acc)
            s1, s2, n_acc = torch.zeros_like(s1), torch.zeros_like(s2), 0
            da = da_restart(da)
    eps_final = (torch.exp(da.log_step_avg) if num_warmup > 0
                 else torch.tensor(init_step_size, dtype=dtype, device=dev))

    zs = torch.empty((num_samples, c, d), dtype=dtype, device=dev)
    aps = torch.empty((num_samples, c), dtype=dtype, device=dev)
    dvgs = torch.empty((num_samples, c), dtype=torch.bool, device=dev)
    for s in range(num_samples):
        z, val, grad, ap, dv, k = step(z, val, grad, eps_final, inv_mass)
        zs[s], aps[s], dvgs[s] = z, ap, dv
        syncs += k
    return BatchedHMCResult(
        samples=zs.transpose(0, 1),
        accept_prob=aps.transpose(0, 1),
        step_size=eps_final,
        inv_mass=inv_mass,
        diverging=dvgs.transpose(0, 1),
        host_syncs=syncs,
        used_leapfrog_fn=leapfrog_fn is not None,
    )
