"""Plain reference of covtype_logreg: log p(w | x, y) and its gradient, in
float64 (``precision="f64"``) or, for the control, float32 with TF32 or bf16
products.  Plain torch; imports nothing of the program."""
from __future__ import annotations

import math

import torch

from bench_port.precision import dtype_of, matmul, softplus

LATENTS = ("w",)


def to_unconstrained(samples: dict) -> dict:
    return {"w": samples["w"]}


def prepare(cfg: dict, data: dict, precision: str) -> dict:
    dt = dtype_of(precision)
    return {"x_t": data["x"].to(dt).T.contiguous(), "y": data["y"].to(dt), "precision": precision,
            "prior_scale": float(cfg["prior_scale"])}


def value_and_grad(prep: dict, z: dict):
    """z {"w": [B, D]} -> (log density [B], {"w": gradient [B, D]})."""
    x_t, y = prep["x_t"], prep["y"]
    w = z["w"].to(x_t.dtype).detach().requires_grad_(True)
    eta = matmul(w, x_t, prep["precision"])
    s = prep["prior_scale"]
    d = w.shape[-1]
    val = (torch.sum(y * eta - softplus(eta), -1) - 0.5 * torch.sum(w * w, -1) / s**2
           - d * (0.5 * math.log(2 * math.pi) + math.log(s)))
    (g,) = torch.autograd.grad(val.sum(), w)
    return val.detach(), {"w": g}
