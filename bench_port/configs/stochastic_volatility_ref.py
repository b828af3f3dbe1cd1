"""Plain reference of stochastic_volatility: the log density of the
unconstrained latents (log sigma and log nu, each with the log-Jacobian of
its exp transform, and the log-volatilities s) and its gradient, in float64
or, for the control, in float32 with the walk's increments and the
StudentT's standardised residuals rounded to TF32's or bf16's mantissa
(``bench_port.precision.ROUND``) in the forward pass and in the gradient
that flows back through them.  The density has no matrix product but the
walk's lag times its coefficient, so these two [B, T] terms are where a
lower precision would enter.  Plain torch; imports nothing of the
program."""
from __future__ import annotations

import math

import torch

from bench_port.precision import ROUND, dtype_of

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LATENTS = ("sigma", "nu", "s")


def to_unconstrained(samples: dict) -> dict:
    return {"sigma": torch.log(samples["sigma"]), "nu": torch.log(samples["nu"]),
            "s": samples["s"]}


def prepare(cfg: dict, data: dict, precision: str) -> dict:
    """The returns as ``x_t`` [1, T] (the harness sizes its blocks by its
    last dimension) and the priors' rates."""
    return {"x_t": data["r"].to(dtype_of(precision))[None, :], "precision": precision,
            "sigma_rate": float(cfg["sigma_rate"]), "nu_rate": float(cfg["nu_rate"])}


class _Rounded(torch.autograd.Function):
    """x rounded to ``precision``'s mantissa, and so is the gradient that
    flows back through it."""

    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return ROUND[precision](x)

    @staticmethod
    def backward(ctx, g):
        return ROUND[ctx.precision](g), None


def _rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x if precision in ("f64", "f32") else _Rounded.apply(x, precision)


def _exponential_log_z(z, rate):
    """log Exponential(rate) density of e^z, plus the log-Jacobian z."""
    return math.log(rate) - rate * torch.exp(z) + z


def value_and_grad(prep: dict, z: dict):
    """z {name: [B, ...]} -> (log density [B], {name: gradient})."""
    r, prec = prep["x_t"][0], prep["precision"]
    zs = {k: z[k].to(r.dtype).detach().requires_grad_(True) for k in LATENTS}
    log_sigma, log_nu, s = zs["sigma"], zs["nu"], zs["s"]
    t = s.shape[-1]
    sigma, nu = torch.exp(log_sigma)[:, None], torch.exp(log_nu)
    # the walk: s_1 ~ N(0, sigma), s_t - s_{t-1} ~ N(0, sigma)
    steps = _rounded(torch.cat([s[:, :1], s[:, 1:] - s[:, :-1]], -1), prec)
    walk = (-0.5 * torch.sum((steps / sigma) ** 2, -1) - t * log_sigma
            - 0.5 * t * math.log(2 * math.pi))
    # the returns: r_t ~ StudentT(nu, 0, e^{s_t})
    resid = _rounded(r * torch.exp(-s), prec)
    student = (t * (torch.lgamma(0.5 * (nu + 1.0)) - torch.lgamma(0.5 * nu)
                    - 0.5 * torch.log(nu * math.pi))
               - torch.sum(s, -1)
               - 0.5 * (nu + 1.0) * torch.sum(torch.log1p(resid * resid / nu[:, None]), -1))
    val = (walk + student + _exponential_log_z(log_sigma, prep["sigma_rate"])
           + _exponential_log_z(log_nu, prep["nu_rate"]))
    grads = torch.autograd.grad(val.sum(), [zs[k] for k in LATENTS])
    return val.detach(), dict(zip(LATENTS, grads))
