"""Bayesian logistic regression at the shape of UCI Covertype (the NumPyro
paper's HMC/NUTS benchmark, arXiv:1912.11554, section 4): N = 581,012 rows,
54 features and an intercept, w ~ N(0, I).  ``sample()`` recognises it as
the Bernoulli GLM family and runs the fused value+grad (K1 on the card)."""
from __future__ import annotations

import torch

from bench_port.frozen import make_logreg_data


def make_data(cfg: dict, row_seed: int, device) -> dict:
    """The fixed data set of ``data_seed``, its rows permuted by ``row_seed``."""
    x, y, _ = make_logreg_data(cfg["num_rows"], cfg["num_features"], cfg["data_seed"], device)
    g = torch.Generator(device=device).manual_seed(int(row_seed))
    perm = torch.randperm(cfg["num_rows"], generator=g, device=device)
    return {"x": x[perm].contiguous(), "y": y[perm].contiguous()}


def build_model(cfg: dict, data: dict):
    import brancher_torch as BT
    import brancher_torch.functions as BF

    d = cfg["num_features"]
    dev = data["x"].device
    w = BT.NormalVariable(torch.zeros(d, device=dev), cfg["prior_scale"] * torch.ones(d, device=dev), "w")
    y = BT.BernoulliVariable(logits=BF.matmul(data["x"], w), name="y")
    y.observe(data["y"])
    return BT.ProbabilisticModel([y])


def work(cfg: dict, chains: int, dim: int) -> dict:
    """Operations and bytes of one value+grad call over ``chains`` states:
    the two products X w and X^T r (2 C N D each); X, y and z read once,
    the value and gradient written once, 4 bytes each."""
    n, d = cfg["num_rows"], cfg["num_features"]
    return {"flops": 4 * chains * n * d, "bytes": 4 * (n * d + n + 2 * chains * dim + chains),
            "dtype": "f32"}
