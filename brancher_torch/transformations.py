"""Invertible transformations and normalizing flows for variational models.

Counterpart of ``brancher_tpu/transformations.py``: ``PlanarFlow``,
``TriangularLinear``, ``Sigmoid`` and ``Shift``, composed by
``TransformedDistribution`` and ``TransformedVariable``.

A flow-transformed variable is ONE random variable whose distribution
draws the base sample, pushes it through the flows and accumulates the
log-density in the same pass (``sample_and_log_prob``), so the whole
reparameterized path is differentiable.  Flows without an analytic
inverse (PlanarFlow) still serve as variational families, since a guide
only needs the density along the sampling direction; ``log_prob`` of an
arbitrary value exists when every flow of the stack is invertible.

The flows' parameters are learnable leaves (``DeterministicVariable``
with ``learnable=True``, named ``{name}__flow{i}_{param}``), so they live
in the compiled model's params and train through the ordinary optimizer,
as in the JAX package.  A guide replays given standard-normal noise
through ``from_noise_and_log_prob`` when the base distribution has a
noise form.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .distributions import REAL, Distribution, Normal, softplus
from .variables import DeterministicVariable, RandomVariable

Tensor = torch.Tensor


class Flow:
    """One invertible map R^d -> R^d with learnable parameters."""

    invertible = True

    def param_inits(self, dim: int) -> Dict[str, Tensor]:
        return {}

    def forward_and_log_det(self, z: Tensor, params: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def inverse(self, x: Tensor, params: Dict[str, Tensor]) -> Tensor:
        raise NotImplementedError


class PlanarFlow(Flow):
    """f(z) = z + u tanh(w.z + b) (Rezende & Mohamed).  No analytic inverse:
    sampling direction only.  Its initial u and w are the JAX package's
    (numpy's RandomState(0))."""

    invertible = False

    def param_inits(self, dim: int) -> Dict[str, Tensor]:
        rng = np.random.RandomState(0)
        return {
            "u": torch.as_tensor(0.1 * rng.normal(size=dim), dtype=torch.float32),
            "w": torch.as_tensor(0.1 * rng.normal(size=dim), dtype=torch.float32),
            "b": torch.zeros((), dtype=torch.float32),
        }

    @staticmethod
    def _u_hat(u, w):
        # invertibility: w.u >= -1
        wu = torch.dot(w, u)
        m = -1.0 + softplus(wu)
        return u + (m - wu) * w / (torch.dot(w, w) + 1e-8)

    def forward_and_log_det(self, z, params):
        u, w, b = params["u"], params["w"], params["b"]
        u = self._u_hat(u, w)
        a = torch.dot(w, z) + b
        f = z + u * torch.tanh(a)
        psi = (1.0 - torch.tanh(a) ** 2) * w
        return f, torch.log(torch.abs(1.0 + torch.dot(u, psi)) + 1e-8)


class TriangularLinear(Flow):
    """f(z) = L z with L lower-triangular, its diagonal exp(log_diag)."""

    def param_inits(self, dim: int) -> Dict[str, Tensor]:
        return {"log_diag": torch.zeros((dim,), dtype=torch.float32),
                "tril": torch.zeros((dim, dim), dtype=torch.float32)}

    @staticmethod
    def _matrix(params):
        return torch.tril(params["tril"], -1) + torch.diag(torch.exp(params["log_diag"]))

    def forward_and_log_det(self, z, params):
        return self._matrix(params) @ z, torch.sum(params["log_diag"])

    def inverse(self, x, params):
        L = self._matrix(params)
        return torch.linalg.solve_triangular(L, x[..., None], upper=False)[..., 0]


class Sigmoid(Flow):
    """Elementwise logistic squashing onto (0, 1)^d."""

    def forward_and_log_det(self, z, params):
        return torch.sigmoid(z), torch.sum(-softplus(z) - softplus(-z))

    def inverse(self, x, params):
        return torch.log(x) - torch.log1p(-x)


class Shift(Flow):
    """f(z) = z + mu (a learnable location)."""

    def param_inits(self, dim: int) -> Dict[str, Tensor]:
        return {"mu": torch.zeros((dim,), dtype=torch.float32)}

    def forward_and_log_det(self, z, params):
        return z + params["mu"], torch.zeros((), dtype=z.dtype, device=z.device)

    def inverse(self, x, params):
        return x - params["mu"]


class TransformedDistribution(Distribution):
    """``base_dist`` pushed through a stack of flows; the density is
    accumulated along with the draw."""

    reparameterized = True
    support = REAL

    def __init__(self, base_dist: Distribution, flows: Sequence[Flow],
                 base_param_names: Sequence[str]):
        self.base_dist = base_dist
        self.flows = list(flows)
        self.base_param_names = tuple(base_param_names)
        if hasattr(base_dist, "from_noise"):
            # a guide draws this variable's standard-normal noise itself
            self.from_noise_and_log_prob = self._from_noise_and_log_prob

    def _split(self, params):
        base_p = {k: params[k] for k in self.base_param_names if k in params}
        flow_ps = []
        for i in range(len(self.flows)):
            prefix = f"flow{i}_"
            flow_ps.append({k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)})
        return base_p, flow_ps

    def _push(self, z, base_p, flow_ps):
        lp = torch.sum(self.base_dist.log_prob(z, **base_p))
        for fl, fp in zip(self.flows, flow_ps):
            z, ld = fl.forward_and_log_det(z, fp)
            lp = lp - ld
        return z, lp

    def sample(self, generator, **params):
        return self.sample_and_log_prob(generator, **params)[0]

    def sample_and_log_prob(self, generator, **params):
        base_p, flow_ps = self._split(params)
        return self._push(self.base_dist.sample(generator, **base_p), base_p, flow_ps)

    def _from_noise_and_log_prob(self, eps, **params):
        base_p, flow_ps = self._split(params)
        return self._push(self.base_dist.from_noise(eps, **base_p), base_p, flow_ps)

    def log_prob(self, value, **params):
        if not all(fl.invertible for fl in self.flows):
            raise NotImplementedError(
                "flow stack contains a non-invertible flow (e.g. PlanarFlow); "
                "density is only available along the sampling path")
        base_p, flow_ps = self._split(params)
        z = value
        logdet = torch.zeros((), dtype=value.dtype, device=value.device)
        for fl, fp in reversed(list(zip(self.flows, flow_ps))):
            z = fl.inverse(z, fp)
            logdet = logdet + fl.forward_and_log_det(z, fp)[1]
        return torch.sum(self.base_dist.log_prob(z, **base_p)) - logdet


def TransformedVariable(name: str, dim: int, flows: Sequence[Flow],
                        base_dist: Optional[Distribution] = None,
                        base_links: Optional[Dict] = None) -> RandomVariable:
    """A flow-transformed latent, its flows' parameters registered as
    learnable leaves::

        qz = TransformedVariable("z", dim=4, flows=[TriangularLinear(), Shift(), PlanarFlow()])
        q = ProbabilisticModel([qz])
    """
    if base_dist is None:
        base_dist = Normal()
        base_links = {"loc": np.zeros(dim, np.float32), "scale": np.ones(dim, np.float32)}
    base_links = dict(base_links or {})
    links = dict(base_links)
    for i, fl in enumerate(flows):
        for pname, init in fl.param_inits(dim).items():
            links[f"flow{i}_{pname}"] = DeterministicVariable(
                init, f"{name}__flow{i}_{pname}", learnable=True)
    dist = TransformedDistribution(base_dist, flows, tuple(base_links.keys()))
    return RandomVariable(dist, name=name, links=links)


__all__ = ["Flow", "PlanarFlow", "TriangularLinear", "Sigmoid", "Shift",
           "TransformedDistribution", "TransformedVariable"]
