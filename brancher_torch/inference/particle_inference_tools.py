"""Particle-based variational inference: Wasserstein VGD and Stein VGD.

Counterpart of ``brancher_tpu/inference/particle_inference_tools.py``.

``run_wvgd``: Wasserstein variational gradient descent by semi-discrete
optimal transport.  The ensemble q = (1/P) sum_i delta(z_i) descends
W2(posterior, q).  Each iteration:

  1. draws M proposal points from a Gaussian mixture centred on the
     particles; self-normalized importance weights w_m ~ p(x_m)/mix(x_m)
     make them weighted posterior samples;
  2. solves the semi-discrete transport between the weighted cloud and the
     equal-mass ensemble, either with an entropic plan
     (``method="sinkhorn"``, ``sinkhorn_plan``, scale 0.25 x the mean
     nearest-particle cost) or by Laguerre-cell dual ascent
     (``method="exact"``, ``dual_ascent_psi`` and ``VoronoiSet`` with power
     weights, the duals warm-started across iterations);
  3. moves each particle toward its plan column's (or cell's) weighted
     barycenter, with a Robbins-Monro decaying step.

``run_svgd``: the kernelized particle flow (the Stein VGD update: a
kernel-smoothed grad log p drift plus repulsion), stepped by an optimizer.

All of it is [M, P] tensor work on the model's device.  The JAX package
runs each engine as one ``lax.scan``; here it is a Python loop over
iterations that never reads a value back to the host (JAX's loop reads
none either): the losses stay on the device until the end.  The random
numbers of an iteration come from the run's ``torch.Generator``, or from
``draw_fn(t) -> (j [M], eps [M, d])`` when given, so that a test can
replay JAX's; ``init_z`` replaces the prior draws of the particles.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..config import make_generator

Tensor = torch.Tensor


class VoronoiSet:
    """Assign points to nearest-particle cells.

    With ``power`` weights psi the cells are Laguerre (power-diagram)
    cells: argmin_i ||x - c_i||^2 - psi_i, the geometry of semi-discrete
    optimal transport, where psi are the Kantorovich dual potentials.
    """

    def __init__(self, centers: Tensor, power: Optional[Tensor] = None):
        self.centers = torch.as_tensor(centers)
        self.power = None if power is None else torch.as_tensor(power)

    def assign(self, points: Tensor) -> Tensor:
        d2 = torch.sum((points[:, None, :] - self.centers[None, :, :]) ** 2, dim=-1)
        if self.power is not None:
            d2 = d2 - self.power[None, :]
        return torch.argmin(d2, dim=-1)

    def _onehot(self, points: Tensor, dtype) -> Tensor:
        return torch.nn.functional.one_hot(self.assign(points), self.centers.shape[0]).to(dtype)

    def cell_counts(self, points: Tensor) -> Tensor:
        return torch.bincount(self.assign(points), minlength=self.centers.shape[0])

    def cell_masses(self, points: Tensor, weights: Tensor) -> Tensor:
        """Total weight landing in each cell."""
        return weights @ self._onehot(points, weights.dtype)

    def cell_barycenters(self, points: Tensor, weights: Tensor):
        """(barycenter per cell, mass per cell); an empty cell keeps its
        center."""
        onehot = self._onehot(points, weights.dtype)  # [M, P]
        mass = weights @ onehot  # [P]
        wx = (weights[:, None] * points).T @ onehot  # [d, P]
        bary = torch.where(mass[None, :] > 1e-12, wx / mass[None, :], self.centers.T)
        return bary.T, mass


def sinkhorn_plan(cost_mat: Tensor, log_w: Tensor, eps, iters: int = 20) -> Tensor:
    """Log-domain Sinkhorn transport plan T [M, P]: row marginals
    exp(log_w) (the weighted cloud), column marginals exactly 1/P (the
    equal-weight ensemble), entropic scale ``eps``."""
    m, p = cost_mat.shape
    neg_c = -cost_mat / eps
    log_col = torch.full((p,), -math.log(float(p)), dtype=cost_mat.dtype, device=cost_mat.device)
    log_a = torch.zeros((m,), dtype=cost_mat.dtype, device=cost_mat.device)
    log_b = torch.zeros((p,), dtype=cost_mat.dtype, device=cost_mat.device)
    for _ in range(iters):
        log_b = log_col - torch.logsumexp(neg_c + log_a[:, None], dim=0)
        log_a = log_w - torch.logsumexp(neg_c + log_b[None, :], dim=1)
    return torch.exp(neg_c + log_a[:, None] + log_b[None, :])


def dual_ascent_psi(cost_mat: Tensor, w: Tensor, psi0: Tensor, psi_lr: float = 1.0,
                    iters: int = 40) -> Tensor:
    """Ascend the semi-discrete Kantorovich duals psi [P].

    The concave dual is F(psi) = sum_i psi_i / P + sum_m w_m min_i (c_mi -
    psi_i); its supergradient is 1/P - mass_i(psi), mass_i the weight in
    Laguerre cell i.  Steps decay as 1/sqrt(k) and scale with the mean
    nearest-cell cost times P.  Returns psi centred to mean 0."""
    p = cost_mat.shape[1]
    scale = torch.mean(torch.min(cost_mat, dim=1).values) + 1e-8
    target = 1.0 / float(p)
    psi = psi0
    for k in range(iters):
        idx = torch.argmin(cost_mat - psi[None, :], dim=1)
        mass = w @ torch.nn.functional.one_hot(idx, p).to(w.dtype)
        eta = psi_lr * scale * p / math.sqrt(1.0 + k)
        psi = psi + eta * (target - mass)
    return psi - torch.mean(psi)


def _median_bandwidth(z: Tensor) -> Tensor:
    """Median-distance heuristic h = sqrt(med^2 / (2 log(P + 1)))."""
    p = z.shape[0]
    d2 = torch.sum((z[:, None, :] - z[None, :, :]) ** 2, dim=-1)
    med2 = torch.quantile(d2.reshape(-1), 0.5)  # numpy's median: the mean of the middle two
    return torch.sqrt(0.5 * med2 / math.log(p + 1.0) + 1e-8)


def particle_update(z: Tensor, grads: Tensor, bandwidth: Optional[float] = None) -> Tensor:
    """One kernelized particle-flow direction phi(z_i):
    phi_i = (1/P) sum_j [k(z_j, z_i) grad_j log p + grad_{z_j} k(z_j, z_i)]."""
    p = z.shape[0]
    h = _median_bandwidth(z) if bandwidth is None else torch.as_tensor(bandwidth, dtype=z.dtype,
                                                                         device=z.device)
    diff = z[:, None, :] - z[None, :, :]  # [P, P, d]
    k = torch.exp(-torch.sum(diff**2, dim=-1) / (2.0 * h**2))  # [P, P]
    drift = k @ grads
    repulse = torch.einsum("ij,ijd->id", k, diff) / (h**2)
    return (drift + repulse) / p


def _prior_particles(comp, params, gen, number_particles: int) -> Tensor:
    """[P, d] unconstrained prior draws (JAX's ``prior_z`` over P keys)."""
    draws = comp.sample(params, gen, number_particles)
    latents = {n: draws[n] for n in comp.continuous_latent_names}
    z_tree = torch.func.vmap(lambda vals: comp.unconstrain(params, vals))(latents)
    return comp.ravel_z(z_tree).to(torch.float32).contiguous()


def _batched_log_density(comp, params) -> Callable[[Tensor], Tensor]:
    return torch.func.vmap(lambda zf: comp.log_density_z(params, comp.unravel_z(zf)))


def _result(joint_model, comp, params, z: Tensor, losses: Tensor):
    from .svi import InferenceResult

    with torch.no_grad():
        particles = torch.func.vmap(lambda zf: comp.constrain(params, comp.unravel_z(zf)))(z)
    curve = losses.cpu().numpy()
    joint_model.diagnostics["loss curve"] = curve
    return InferenceResult({"particles_z": z}, curve, extras={"particles": particles})


def _wvgd_step(z: Tensor, psi: Tensor, t: int, j: Tensor, eps: Tensor, logp_batch, *,
              number_iterations: int, lr: float, proposal_scale: float = 1.0,
              method: str = "sinkhorn", psi_lr: float = 1.0, sinkhorn_iters: int = 20,
              dual_iters: int = 40):
    """One WVGD iteration from particles ``z`` [P, d] and duals ``psi`` [P]
    with proposal picks ``j`` [M] and standard-normal noise ``eps`` [M, d]:
    returns (z, psi, transport cost)."""
    # Robbins-Monro decay: the barycenter estimates are noisy
    lr_t = lr / (1.0 + 3.0 * float(t) / number_iterations)
    # proposal: a Gaussian mixture on the particles, its width the
    # ensemble's spread per coordinate
    sd = proposal_scale * (torch.std(z, dim=0, correction=0) + 1e-5)  # [d]
    x = z[j] + sd[None, :] * eps
    xn, zn = x / sd[None, :], z / sd[None, :]
    d2_prop = (torch.sum(xn * xn, -1)[:, None] + torch.sum(zn * zn, -1)[None, :]
               - 2.0 * xn @ zn.T)  # [M, P]
    log_mix = torch.logsumexp(-0.5 * d2_prop, dim=1)
    # self-normalized importance weights toward the posterior
    w = torch.softmax(logp_batch(x) - log_mix, dim=0)
    # semi-discrete OT between (x, w) and the equal-mass ensemble
    cost_mat = torch.sum(x * x, -1)[:, None] + torch.sum(z * z, -1)[None, :] - 2.0 * x @ z.T
    if method == "sinkhorn":
        eps_t = 0.25 * torch.mean(torch.min(cost_mat, dim=1).values) + 1e-8
        t_plan = sinkhorn_plan(cost_mat, torch.log(w + 1e-38), eps_t, sinkhorn_iters)
        col_mass = torch.sum(t_plan, dim=0)  # about 1/P each
        bary = (t_plan.T @ x) / torch.clamp(col_mass, min=1e-12)[:, None]
        cost = torch.sum(t_plan * cost_mat)
    else:
        psi = dual_ascent_psi(cost_mat, w, psi, psi_lr, dual_iters)
        cells = VoronoiSet(z, power=psi)
        bary, _ = cells.cell_barycenters(x, w)
        idx = cells.assign(x)
        cost = torch.sum(w * cost_mat[torch.arange(x.shape[0], device=x.device), idx])
    return z + lr_t * (bary - z), psi, cost


def run_wvgd(joint_model, number_iterations: int = 500, number_particles: int = 50,
             optimizer="adam", lr: float = 0.5, key=None, number_samples: int = 512,
             proposal_scale: float = 1.0, psi_lr: float = 1.0, method: str = "sinkhorn",
             device=None, init_z: Optional[Tensor] = None,
             draw_fn: Optional[Callable[[int], tuple]] = None):
    """Wasserstein variational gradient descent (semi-discrete OT).

    ``optimizer`` is unused: the W2 flow has its own step rule.  method
    "sinkhorn" (default) uses the entropic plan, whose bias vanishes as the
    ensemble contracts; "exact" the Laguerre-cell dual ascent with rate
    ``psi_lr`` (ignored by "sinkhorn").  ``init_z`` [P, d] replaces the
    prior draws; ``draw_fn(t)`` returns iteration t's (j, eps) in place of
    the generator's."""
    del optimizer
    if method not in ("sinkhorn", "exact"):
        raise ValueError(f"unknown WVGD method {method!r}")
    comp = joint_model.compiled(device)
    dev = comp.device
    gen = make_generator(key, dev)
    params = comp.initial_params
    z = (_prior_particles(comp, params, gen, number_particles) if init_z is None
         else torch.as_tensor(init_z, dtype=torch.float32, device=dev))
    p, d = z.shape
    logp_batch = _batched_log_density(comp, params)
    psi = torch.zeros((p,), dtype=z.dtype, device=dev)
    losses = torch.empty((number_iterations,), device=dev)
    with torch.no_grad():
        for t in range(number_iterations):
            if draw_fn is None:
                j = torch.randint(0, p, (number_samples,), generator=gen, device=dev)
                eps = torch.randn((number_samples, d), generator=gen, device=dev)
            else:
                j, eps = draw_fn(t)
            z, psi, losses[t] = _wvgd_step(
                z, psi, t, j, eps, logp_batch, number_iterations=number_iterations, lr=lr,
                proposal_scale=proposal_scale, method=method, psi_lr=psi_lr)
    return _result(joint_model, comp, params, z, losses)


def run_svgd(joint_model, number_iterations: int = 500, number_particles: int = 50,
             optimizer="adam", lr: float = 0.05, key=None,
             kernel_bandwidth: Optional[float] = None, device=None,
             init_z: Optional[Tensor] = None):
    """Kernelized particle flow (the Stein VGD update rule), stepped by
    ``optimizer`` (optax's rules, ``optimizers.resolve_optimizer``) on
    -phi; the loss is -mean log p over the particles after each step."""
    from ..optimizers import resolve_optimizer

    comp = joint_model.compiled(device)
    dev = comp.device
    gen = make_generator(key, dev)
    params = comp.initial_params
    z0 = (_prior_particles(comp, params, gen, number_particles) if init_z is None
          else torch.as_tensor(init_z, dtype=torch.float32, device=dev))
    logp = lambda zf: comp.log_density_z(params, comp.unravel_z(zf))  # noqa: E731
    grad_logp = torch.func.vmap(torch.func.grad(logp))
    logp_batch = torch.func.vmap(logp)
    z = z0.clone().requires_grad_(True)
    opt = resolve_optimizer(optimizer, lr)([z])
    losses = torch.empty((number_iterations,), device=dev)
    for t in range(number_iterations):
        with torch.no_grad():
            zd = z.detach()
            z.grad = -particle_update(zd, grad_logp(zd), kernel_bandwidth)
        opt.step()
        with torch.no_grad():
            losses[t] = -torch.mean(logp_batch(z.detach()))
    return _result(joint_model, comp, params, z.detach(), losses)


__all__ = ["VoronoiSet", "sinkhorn_plan", "dual_ascent_psi", "particle_update",
           "run_wvgd", "run_svgd"]
