"""Variational guides (posterior families) for SVI.

Counterpart of ``brancher_tpu/inference/guides.py``: ``DSLGuide`` (a
user-built ProbabilisticModel attached with ``set_posterior_model``),
``AutoMeanField``, ``AutoFullRankNormal`` and ``AutoIAF`` (an inverse-
autoregressive flow of MADE-masked dense layers), with ``made_masks``.

Guide protocol (read by the ELBO in ``svi.py``):
  * ``space``: "constrained" (values keyed by latent name) or
    "unconstrained" (flat z of the target's ``CompiledModel``);
  * ``init_params(generator)``;
  * ``sample_and_log_prob(params, generator, n, detach, deterministic,
    given, noise=None)`` -> (values with a leading sample axis, log_q [n]).
    ``noise`` replaces the generator's standard-normal draws: [n, dim] for
    the automatic guides, {name: [n, *shape]} over the sampled variables
    for ``DSLGuide``.

The JAX guides split a key per sample and vmap; ``torch.func.vmap``
refuses random draws, so here the noise is drawn first with the explicit
generator (or passed in, to replay JAX's numbers in a test) and the
samples are then mapped through the guide, batched.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..compiler import CompiledModel
from ..variables import RandomVariable

Tensor = torch.Tensor
_LOG_2PI = math.log(2.0 * math.pi)


def _flat_eps(dim: int, device, generator, n: int, deterministic: bool,
              noise: Optional[Tensor]) -> Tensor:
    """The [n, dim] standard-normal draws of a flat guide: zeros at the mean
    (``deterministic``), else ``noise`` when given, else fresh draws."""
    if deterministic:
        return torch.zeros((n, dim), device=device)
    if noise is not None:
        if tuple(noise.shape) != (n, dim):
            raise ValueError(f"noise must be [{n}, {dim}], got {tuple(noise.shape)}")
        return noise
    return torch.randn((n, dim), generator=generator, device=device)


class DSLGuide:
    """Adapter: a user-built ProbabilisticModel as variational family.

    Sampling happens in CONSTRAINED space; log q is the guide model's own
    log-joint of its sampled values (``given`` data loaders included, whose
    log-probs are zero).  Latent correspondence with the target model is by
    variable name.  The guide compiles on ``device``, the target's.
    """

    space = "constrained"

    def __init__(self, q_model, device=None):
        self.q_model = q_model
        self.comp: CompiledModel = q_model.compiled(device)

    def init_params(self, generator):
        return self.comp.initial_params

    def _sampled(self, given) -> list:
        # the walk draws every random variable not given, observed ones too
        return [v for v in self.comp.order if isinstance(v, RandomVariable) and v.name not in given]

    def _noise(self, generator, n: int, given) -> Optional[Dict[str, Tensor]]:
        """Standard-normal draws for every variable the walk samples, or None
        where one of them has no noise form (``from_noise``)."""
        sampled = self._sampled(given)
        if not sampled or not all(hasattr(v.distribution, "from_noise")
                                  or hasattr(v.distribution, "from_noise_and_log_prob")
                                  for v in sampled):
            return None
        return {v.name: torch.randn((n,) + self.comp.shapes[v.name], generator=generator,
                                    device=self.comp.device) for v in sampled}

    def sample_and_log_prob(self, params, generator, n, detach=False, deterministic=False,
                            given=None, noise=None):
        comp = self.comp
        g = {k: v for k, v in (given or {}).items() if k in set(comp.names)}
        store = comp._as_store(params)
        if deterministic:
            mean = comp._walk_mean(store, g)
            logq = comp._walk_log_prob(store, mean).expand(n)
            values = {k: v.expand((n,) + tuple(v.shape)) for k, v in mean.items()}
        else:
            if noise is None:
                noise = self._noise(generator, n, g)
            if noise is None:  # a variable without a noise form: one walk a sample
                walks = [comp._walk_sample(store, generator, g) for _ in range(n)]
                values = {k: torch.stack([w[0][k] for w in walks]) for k in walks[0][0]}
                logq = torch.stack([w[1] for w in walks])
            else:
                values, logq = torch.func.vmap(
                    lambda nz: comp._walk_sample(store, None, g, nz))(noise)
        if detach:
            values = {k: v.detach() for k, v in values.items()}
            # recompute log q differentiably in params from the RANDOM
            # variables' values only: deterministic nodes (learnable leaves)
            # must be re-derived from params, or the score gradient is zero
            rv_names = set(comp.latent_names) | set(comp.observed_names)
            logq = comp.log_prob(params, {k: v for k, v in values.items() if k in rv_names})
        return values, logq


class AutoMeanField:
    """Diagonal Normal over the flat unconstrained latent vector."""

    space = "unconstrained"

    def __init__(self, comp: CompiledModel, init_scale: float = 0.1):
        self.comp = comp
        self.dim = comp.dim
        self.init_scale = init_scale

    def init_params(self, generator):
        dev = self.comp.device
        loc = 0.01 * torch.randn((self.dim,), generator=generator, device=dev)
        return {"loc": loc, "log_scale": torch.full((self.dim,), math.log(self.init_scale), device=dev)}

    def sample_and_log_prob(self, params, generator, n, detach=False, deterministic=False,
                            given=None, noise=None):
        eps = _flat_eps(self.dim, self.comp.device, generator, n, deterministic, noise)
        loc, log_scale = params["loc"], params["log_scale"]
        scale = torch.exp(log_scale)
        z = loc + scale * eps
        logq = torch.sum(-0.5 * eps**2 - 0.5 * _LOG_2PI - log_scale, dim=-1)
        if detach:
            z = z.detach()
            logq = torch.sum(-0.5 * ((z - loc) / scale) ** 2 - 0.5 * _LOG_2PI - log_scale, dim=-1)
        return self.comp.unravel_z(z), logq

    def posterior_moments(self, params) -> Tuple[Tensor, Tensor]:
        return params["loc"], torch.exp(2.0 * params["log_scale"])


class AutoFullRankNormal:
    """Full-covariance Normal via a lower-triangular scale factor."""

    space = "unconstrained"

    def __init__(self, comp: CompiledModel, init_scale: float = 0.1):
        self.comp = comp
        self.dim = comp.dim
        self.init_scale = init_scale

    def init_params(self, generator):
        d, dev = self.dim, self.comp.device
        return {
            "loc": 0.01 * torch.randn((d,), generator=generator, device=dev),
            "log_diag": torch.full((d,), math.log(self.init_scale), device=dev),
            "tril": torch.zeros((d, d), device=dev),
        }

    def _scale_tril(self, params) -> Tensor:
        return torch.tril(params["tril"], -1) + torch.diag(torch.exp(params["log_diag"]))

    def sample_and_log_prob(self, params, generator, n, detach=False, deterministic=False,
                            given=None, noise=None):
        L = self._scale_tril(params)
        eps = _flat_eps(self.dim, self.comp.device, generator, n, deterministic, noise)
        const = 0.5 * self.dim * _LOG_2PI + torch.sum(params["log_diag"])
        z = params["loc"] + eps @ L.T
        logq = -0.5 * torch.sum(eps**2, dim=-1) - const
        if detach:
            z = z.detach()
            solve = torch.linalg.solve_triangular(L, (z - params["loc"]).T, upper=False).T
            logq = -0.5 * torch.sum(solve**2, dim=-1) - const
        return self.comp.unravel_z(z), logq


def _made_degrees(d: int, hidden: int):
    deg_in = np.arange(1, d + 1)
    if d > 1:
        deg_hidden = (np.arange(hidden) % (d - 1)) + 1
    else:
        deg_hidden = np.ones(hidden, dtype=int)
    deg_out = np.arange(1, d + 1)
    return deg_in, deg_hidden, deg_out


def made_masks(d: int, hidden: int) -> Tuple[Tensor, Tensor]:
    """MADE masks for one autoregressive layer pair (in->hidden->out)."""
    deg_in, deg_h, deg_out = _made_degrees(d, hidden)
    m1 = (deg_h[None, :] >= deg_in[:, None]).astype(np.float32)  # [d, h]
    m2 = (deg_out[None, :] > deg_h[:, None]).astype(np.float32)  # [h, d] strict
    return torch.from_numpy(m1), torch.from_numpy(m2)


class AutoIAF:
    """Inverse-autoregressive-flow guide: z = flow(eps) with one-pass
    sampling; MADE-masked dense layers keep everything as dense matmuls."""

    space = "unconstrained"

    def __init__(self, comp: CompiledModel, num_flows: int = 3, hidden: int = 64,
                 init_scale: float = 0.1):
        self.comp = comp
        self.dim = comp.dim
        self.num_flows = num_flows
        self.hidden = max(hidden, 2 * self.dim)
        self.init_scale = init_scale
        self.mask1, self.mask2 = (m.to(comp.device) for m in made_masks(self.dim, self.hidden))

    def init_params(self, generator):
        d, h, dev = self.dim, self.hidden, self.comp.device
        params = {"base_loc": torch.zeros((d,), device=dev),
                  "base_log_scale": torch.full((d,), math.log(self.init_scale), device=dev)}
        for i in range(self.num_flows):
            params[f"flow{i}"] = {
                "w1": 0.1 * torch.randn((d, h), generator=generator, device=dev) / np.sqrt(d),
                "b1": torch.zeros((h,), device=dev),
                "w2_m": 0.1 * torch.randn((h, d), generator=generator, device=dev) / np.sqrt(h),
                "w2_s": torch.zeros((h, d), device=dev),
                "b2_m": torch.zeros((d,), device=dev),
                "b2_s": torch.zeros((d,), device=dev),
            }
        return params

    def _flow_forward(self, params, z: Tensor) -> Tuple[Tensor, Tensor]:
        """All IAF layers over z [n, d]: (z_out, sum of log-dets [n])."""
        logdet = torch.zeros(z.shape[:-1], device=z.device)
        for i in range(self.num_flows):
            p = params[f"flow{i}"]
            hidden = torch.tanh(z @ (p["w1"] * self.mask1) + p["b1"])
            m = hidden @ (p["w2_m"] * self.mask2) + p["b2_m"]
            s = torch.tanh(hidden @ (p["w2_s"] * self.mask2) + p["b2_s"])  # bounded log-scale
            z = z * torch.exp(s) + m
            logdet = logdet + torch.sum(s, dim=-1)
            z = torch.flip(z, dims=(-1,))  # reverse ordering between layers
        return z, logdet

    def sample_and_log_prob(self, params, generator, n, detach=False, deterministic=False,
                            given=None, noise=None):
        if detach:
            raise NotImplementedError(
                "score-function estimation needs an invertible log_prob; "
                "use the pathwise estimator with AutoIAF"
            )
        eps = _flat_eps(self.dim, self.comp.device, generator, n, deterministic, noise)
        base_scale = torch.exp(params["base_log_scale"])
        z0 = params["base_loc"] + base_scale * eps
        log_base = torch.sum(-0.5 * eps**2 - 0.5 * _LOG_2PI - params["base_log_scale"], dim=-1)
        z, logdet = self._flow_forward(params, z0)
        return self.comp.unravel_z(z), log_base - logdet
