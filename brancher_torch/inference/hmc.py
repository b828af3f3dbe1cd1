"""Hamiltonian Monte Carlo kernel configuration.

Counterpart of ``brancher_tpu/inference/hmc.py``: the ``HMC`` settings
that ``sample()`` reads (lines 66-75), ``kinetic_energy`` (line 34) and
``hmc_sample`` (line 111).  ``sample()`` runs HMC with the chain-batched
engine ``ops.batched_hmc.hmc_batched``.  The per-chain ``leapfrog``,
``make_step`` and ``ChainState`` serve only the per-chain ``vmap``
engines, which are still to port (ROADMAP queue 1, item 12).

Also here, shared by the chain-batched HMC and ChEES engines: their
injectable randomness source (``TorchHMCRandom``) and the loop
integrator (``loop_leapfrog``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor
VG = Callable[[Tensor], Tuple[Tensor, Tensor]]


def kinetic_energy(r: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    """1/2 r^T M^-1 r for a diagonal inverse mass, over the last axis."""
    return 0.5 * torch.sum(r * r * inv_mass, dim=-1)


class TorchHMCRandom:
    """The randomness of HMC/ChEES transitions, from a torch.Generator.

    ``momentum(z)``: standard normals shaped like z; ``accept(c, like)``:
    uniforms [C]; ``num_steps(high, device)``: a 0-d int tensor, uniform
    in [1, high], drawn on the device (no host sync).
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def momentum(self, z: Tensor) -> Tensor:
        return torch.randn(z.shape, generator=self.generator, device=z.device, dtype=z.dtype)

    def accept(self, c: int, like: Tensor) -> Tensor:
        return torch.rand((c,), generator=self.generator, device=like.device, dtype=like.dtype)

    def num_steps(self, high: int, device) -> Tensor:
        return torch.randint(1, high + 1, (), generator=self.generator, device=device)


def loop_leapfrog(value_and_grad_fn: VG, z, r, grad, eps, inv_mass, n_steps: int,
                  h0: Optional[Tensor] = None, kinetic=kinetic_energy,
                  velocity=None, max_delta_energy: float = 1000.0):
    """``n_steps`` velocity-Verlet steps of ``value_and_grad_fn`` (a LOG
    density).  With ``h0`` the energy error is checked after every step;
    returns (z, r, val, grad, diverging [C]).  ``val`` is 0 when no step
    runs, as in the JAX loop."""
    velocity = velocity or (lambda rr: rr * inv_mass[None, :])
    val = torch.zeros((z.shape[0],), dtype=z.dtype, device=z.device)
    div = torch.zeros((z.shape[0],), dtype=torch.bool, device=z.device)
    for _ in range(n_steps):
        r = r + 0.5 * eps * grad
        z = z + eps * velocity(r)
        val, grad = value_and_grad_fn(z)
        r = r + 0.5 * eps * grad
        if h0 is not None:
            h = -val + kinetic(r, inv_mass)
            div = div | ~(h - h0 < max_delta_energy)  # NaN counts
    return z, r, val, grad, div


class HMC:
    """HMC kernel config (plugs into mcmc.sample).

    num_integration_steps: leapfrog steps per transition, or the upper
    end of the uniform draw in [1, num_integration_steps] when
    ``jitter_steps`` is set.
    """

    def __init__(self, num_integration_steps: int = 32, jitter_steps: bool = True,
                 target_accept: float = 0.8, max_delta_energy: float = 1000.0):
        self.num_integration_steps = num_integration_steps
        self.jitter_steps = jitter_steps
        self.target_accept = target_accept
        self.max_delta_energy = max_delta_energy


def hmc_sample(model, **kwargs):
    """Convenience: run HMC on a ProbabilisticModel (see mcmc.sample)."""
    from .mcmc import sample

    kernel = HMC(**{k: kwargs.pop(k) for k in list(kwargs)
                    if k in ("num_integration_steps", "jitter_steps", "target_accept")})
    return sample(model, kernel=kernel, **kwargs)
