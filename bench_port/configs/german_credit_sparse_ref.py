"""Plain reference of german_credit_sparse: the log density of the
unconstrained latents (log scales, unscaled weights; the log-Jacobian of the
exp transforms included) and its gradient, in float64 or, for the control,
float32 with TF32 or bf16 products.  Plain torch; imports nothing of the
program."""
from __future__ import annotations

import math

import torch

from bench_port.precision import dtype_of, matmul, softplus

LATENTS = ("global_scale", "local_scales", "unscaled_weights")


def to_unconstrained(samples: dict) -> dict:
    return {"global_scale": torch.log(samples["global_scale"]),
            "local_scales": torch.log(samples["local_scales"]),
            "unscaled_weights": samples["unscaled_weights"]}


def prepare(cfg: dict, data: dict, precision: str) -> dict:
    dt = dtype_of(precision)
    return {"x_t": data["x"].to(dt).T.contiguous(), "y": data["y"].to(dt), "precision": precision,
            "a": float(cfg["gamma_concentration"]), "b": float(cfg["gamma_rate"])}


def _gamma_log_z(z, a, b):
    """log Gamma(a, b) density of e^z, plus the log-Jacobian z."""
    return a * math.log(b) + a * z - b * torch.exp(z) - math.lgamma(a)


def value_and_grad(prep: dict, z: dict):
    """z {name: [B, ...]} -> (log density [B], {name: gradient})."""
    x_t, y, a, b = prep["x_t"], prep["y"], prep["a"], prep["b"]
    zs = {k: z[k].to(x_t.dtype).detach().requires_grad_(True) for k in LATENTS}
    zg, zl, u = zs["global_scale"], zs["local_scales"], zs["unscaled_weights"]
    w = u * torch.exp(zl) * torch.exp(zg)[:, None]
    eta = matmul(w, x_t, prep["precision"])
    val = (torch.sum(y * eta - softplus(eta), -1) + _gamma_log_z(zg, a, b)
           + torch.sum(_gamma_log_z(zl, a, b), -1)
           - 0.5 * torch.sum(u * u, -1) - 0.5 * u.shape[-1] * math.log(2 * math.pi))
    grads = torch.autograd.grad(val.sum(), [zs[k] for k in LATENTS])
    return val.detach(), dict(zip(LATENTS, grads))
