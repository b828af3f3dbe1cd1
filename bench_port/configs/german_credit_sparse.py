"""Sparse (ARD) hierarchical logistic regression at the shape of German
Credit (numeric): N = 1000 rows, 24 features and an intercept, as in NeuTra
(arXiv:1903.03704) and ChEES-HMC (AISTATS 2021).  A global and D local
Gamma(0.5, 0.5) scales times D standard-normal weights: 51 latent
dimensions.  Not a GLM family, so ``sample()`` differentiates the compiled
log density (replayed from a CUDA graph on the card)."""
from __future__ import annotations

import torch


def make_data(cfg: dict, row_seed: int, device) -> dict:
    """The fixed data set of ``data_seed``, its rows permuted by ``row_seed``."""
    n, d = cfg["num_rows"], cfg["num_features"]
    g = torch.Generator(device=device).manual_seed(int(cfg["data_seed"]))
    w_true = torch.zeros(d, device=device)
    idx = torch.randperm(d, generator=g, device=device)[: cfg["true_nonzero"]]
    w_true[idx] = torch.randn(cfg["true_nonzero"], generator=g, device=device)
    x = torch.randn(n, d, generator=g, device=device)
    x[:, 0] = 1.0
    y = (torch.rand(n, generator=g, device=device) < torch.sigmoid(x @ w_true)).to(torch.int32)
    perm = torch.randperm(n, generator=torch.Generator(device=device).manual_seed(int(row_seed)),
                          device=device)
    return {"x": x[perm].contiguous(), "y": y[perm].contiguous()}


def build_model(cfg: dict, data: dict):
    import brancher_torch as BT
    import brancher_torch.functions as BF

    d = cfg["num_features"]
    dev = data["x"].device
    a, b = cfg["gamma_concentration"], cfg["gamma_rate"]
    glob = BT.GammaVariable(a, b, "global_scale")
    local = BT.GammaVariable(a * torch.ones(d, device=dev), b * torch.ones(d, device=dev), "local_scales")
    unscaled = BT.NormalVariable(torch.zeros(d, device=dev), torch.ones(d, device=dev), "unscaled_weights")
    y = BT.BernoulliVariable(logits=BF.matmul(data["x"], unscaled * local * glob), name="y")
    y.observe(data["y"])
    return BT.ProbabilisticModel([y])


def work(cfg: dict, chains: int, dim: int) -> dict:
    """Operations and bytes of one value+grad call, counted as the GLM's:
    X w and X^T r (2 C N D each); X, y and z read once, the value and
    gradient written once, 4 bytes each."""
    n, d = cfg["num_rows"], cfg["num_features"]
    return {"flops": 4 * chains * n * d, "bytes": 4 * (n * d + n + 2 * chains * dim + chains),
            "dtype": "f32"}
