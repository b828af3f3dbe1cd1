"""Warmup adaptation: dual averaging and the Stan window schedule.

Counterpart of ``brancher_tpu/inference/adaptation.py`` (lines 25-242):
``DualAveragingState``, ``da_init``, ``da_update``, ``da_restart``,
``build_warmup_schedule``, the Welford estimator, and the step-size
probes ``find_reasonable_step_size`` (per chain) and
``find_reasonable_step_size_batched`` (one shared step), the
chain-batched engines' diagonal-mass update (``diag_mass_update``, inline
in each JAX engine), and the cross-rank consensus of sharded chains
(``pmean_if`` and ``psum_if``, JAX lines 179-185).

The dual-averaging state is five 0-d float32 tensors on the run's device,
updated with the same float32 operations as the JAX package, so the step
size stays on the device and a warmup iteration needs no host sync.  The
per-chain pieces work on a whole block of chains at once: where JAX
``vmap``s a per-chain function, the port's takes a leading chain axis
(``WelfordState`` with ``batch=(C,)``, ``find_reasonable_step_size``
over [C, d]) and gives each chain what its own call would.

Where JAX takes an ``axis_name``, the port takes ``axis``: the mesh's
chain dimension (``parallel.collectives.Axis``: its process group, size
and this rank's place), or None for an unsharded run.  Only
warmup reduces over it, between transitions, so every rank issues the
same collectives in the same order whatever its own tree depths.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.collectives import pmean, psum
from .hmc import init_chain_state, kinetic_energy, leapfrog

Tensor = torch.Tensor


class DualAveragingState(NamedTuple):
    log_step: Tensor
    log_step_avg: Tensor
    grad_avg: Tensor
    t: Tensor
    mu: Tensor


def da_init(step_size: Tensor) -> DualAveragingState:
    log_step = torch.log(torch.as_tensor(step_size, dtype=torch.float32))
    zero = torch.zeros_like(log_step)
    return DualAveragingState(
        log_step=log_step, log_step_avg=zero, grad_avg=zero, t=zero,
        mu=math.log(10.0) + log_step,
    )


def da_update(
    state: DualAveragingState,
    accept_prob: Tensor,
    target_accept: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    t = state.t + 1.0
    g = target_accept - accept_prob
    eta_g = 1.0 / (t + t0)
    grad_avg = (1.0 - eta_g) * state.grad_avg + eta_g * g
    log_step = state.mu - torch.sqrt(t) / gamma * grad_avg
    eta_x = t ** (-kappa)
    log_step_avg = eta_x * log_step + (1.0 - eta_x) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, grad_avg, t, state.mu)


def da_restart(state: DualAveragingState) -> DualAveragingState:
    """Reset the averaging stats around the current step size (new window)."""
    return da_init(torch.exp(state.log_step))


class WelfordState(NamedTuple):
    mean: Tensor  # batch + [d]
    m2: Tensor  # batch + [d]
    count: Tensor  # batch


def welford_init(dim: int, dtype=torch.float32, device=None, batch: Tuple[int, ...] = ()) -> WelfordState:
    """An empty running-variance estimate of ``dim`` coordinates, one for
    each index of ``batch`` (JAX ``vmap``s the per-chain one)."""
    zeros = torch.zeros(tuple(batch) + (dim,), dtype=dtype, device=device)
    return WelfordState(zeros, zeros.clone(), torch.zeros(tuple(batch), dtype=dtype, device=device))


def welford_update(state: WelfordState, x: Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(state: WelfordState, regularize: bool = True) -> Tensor:
    var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)[..., None]
    if regularize:
        # Stan's shrinkage toward unit: n/(n+5) var + 1e-3 * 5/(n+5)
        n = state.count[..., None]
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def build_warmup_schedule(
    num_warmup: int,
    init_buffer: int = 75,
    term_buffer: int = 50,
    base_window: int = 25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stan's three-phase schedule as mask arrays (in_slow_window[W],
    window_end[W]): slow-window steps feed the mass estimate; at each
    window end the mass matrix updates and dual averaging restarts."""
    w = int(num_warmup)
    in_slow = np.zeros(w, dtype=bool)
    window_end = np.zeros(w, dtype=bool)
    if w == 0:
        return in_slow, window_end
    if w < init_buffer + term_buffer + base_window:
        # degenerate short warmup: single slow window in the middle
        start = min(init_buffer, max(0, w // 4))
        end = max(start + 1, w - min(term_buffer, w // 4))
        in_slow[start:end] = True
        window_end[end - 1] = True
        return in_slow, window_end
    start = init_buffer
    size = base_window
    while start < w - term_buffer:
        end = start + size
        if end + 2 * size > w - term_buffer:
            end = w - term_buffer  # absorb remainder into last window
        in_slow[start:end] = True
        window_end[end - 1] = True
        start = end
        size *= 2
    return in_slow, window_end


def diag_mass_update(s1: Tensor, s2: Tensor, n_acc: float) -> Tensor:
    """The diagonal inverse mass at a window end of the chain-batched
    engines: the cross-chain variance of the window's ``n_acc`` draws
    (sums ``s1``, squares ``s2``), shrunk towards 1e-3 (Stan's rule)."""
    ng = float(n_acc)
    mean = s1 / max(ng, 1.0)
    var = s2 / max(ng, 1.0) - mean * mean
    return (ng / (ng + 5.0)) * var + 1e-3 * (5.0 / (ng + 5.0))


def pmean_if(x: Tensor, axis=None) -> Tensor:
    """The mean of ``x`` over the ranks of ``axis`` (a
    ``parallel.collectives.Axis``: JAX's ``pmean`` over the chain axis);
    ``x`` itself when ``axis`` is None."""
    return x if axis is None else pmean(x, axis)


def psum_if(x: Tensor, axis=None) -> Tensor:
    """The sum of ``x`` over the ranks of ``axis``; ``x`` when None."""
    return x if axis is None else psum(x, axis)


def find_reasonable_step_size(
    value_and_grad_fn,
    z: Tensor,
    inv_mass: Tensor,
    generator: Optional[torch.Generator] = None,
    init_step: float = 1.0,
    target: float = 0.8,
    max_iters: int = 50,
    noise: Optional[Tensor] = None,
) -> Tensor:
    """Hoffman & Gelman alg. 4 for each chain of a [C, d] block: each
    chain's step is doubled (or halved) until its own one-step accept
    probability crosses the target, or ``max_iters`` times.  Returns [C].

    ``value_and_grad_fn`` maps [C, d] to (log density [C], its gradient);
    the arithmetic is JAX's on the potential energy (its negation).  A
    chain that has crossed keeps its step while the others go on, as under
    JAX's ``vmap`` of the per-chain ``while_loop``; one host sync an
    iteration.  ``noise``: the momenta's standard normals (from
    ``generator`` when None).
    """
    if noise is None:
        noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
    state = init_chain_state(value_and_grad_fn, z)
    r = noise / torch.sqrt(inv_mass)
    h0 = state.pe + kinetic_energy(r, inv_mass)

    def accept_prob(step):
        _, r1, pe1, _ = leapfrog(value_and_grad_fn, z, r, state.grad, step, inv_mass, 1)
        h1 = pe1 + kinetic_energy(r1, inv_mass)
        p = torch.exp(torch.clamp(h0 - h1, -1e3, 0.0))
        return torch.where(torch.isfinite(h1), p, torch.zeros_like(p))

    step = torch.full(z.shape[:1], init_step, dtype=z.dtype, device=z.device)
    p = accept_prob(step)
    up = p > target
    for _ in range(max_iters):
        running = ~torch.where(up, p <= target, p >= target)
        if not bool(running.any()):
            break
        new_step = step * torch.where(up, 2.0, 0.5).to(step.dtype)
        p = torch.where(running, accept_prob(new_step), p)
        step = torch.where(running, new_step, step)
    return step


def find_reasonable_step_size_batched(
    value_and_grad_fn,
    z: Tensor,
    inv_mass: Tensor,
    generator: Optional[torch.Generator] = None,
    init_step: float = 1.0,
    target: float = 0.8,
    num_iters: int = 20,
    noise: Optional[Tensor] = None,
    axis=None,
) -> Tensor:
    """Hoffman & Gelman alg. 4 for the chain-batched engines: ONE shared
    step size, doubled or halved until the cross-chain MEAN one-step
    accept probability crosses the target.

    The JAX version runs ``num_iters`` masked iterations; once the target
    is crossed they change nothing, so this loop stops there (one host
    sync per iteration, once per sampler run).  ``noise`` are the standard
    normals of the momenta ([C, D]; drawn from ``generator`` when None).
    With ``axis`` the mean accept probability is the mean over its ranks
    of each rank's chain mean (JAX ``:221``), the same on every rank, so
    every rank stops at the same iteration.
    """
    if noise is None:
        noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
    val0, grad0 = value_and_grad_fn(z)
    r = noise / torch.sqrt(inv_mass)[None, :]
    h0 = -val0 + 0.5 * torch.sum(r * r * inv_mass[None, :], -1)

    def mean_accept(step):
        r1 = r + 0.5 * step * grad0
        z1 = z + step * inv_mass[None, :] * r1
        val1, grad1 = value_and_grad_fn(z1)
        r2 = r1 + 0.5 * step * grad1
        h1 = -val1 + 0.5 * torch.sum(r2 * r2 * inv_mass[None, :], -1)
        h1 = torch.where(torch.isfinite(h1), h1, torch.full_like(h1, math.inf))
        return pmean_if(torch.mean(torch.exp(torch.clamp(h0 - h1, max=0.0))), axis)

    step = torch.tensor(init_step, dtype=z.dtype, device=z.device)
    p = mean_accept(step)
    up = bool(p > target)  # accept too high -> grow the step
    for _ in range(num_iters):
        crossed = bool(p <= target) if up else bool(p >= target)
        if crossed:
            break
        step = step * (2.0 if up else 0.5)
        p = mean_accept(step)
    return torch.clamp(step, 1e-6, 1e3)
