"""Stochastic volatility over T = 3,000 daily returns: the SV experiment of
the NUTS paper (Hoffman & Gelman, arXiv:1111.4246), in the form of
NumPyro's ``examples/stochastic_volatility.py``.  sigma ~ Exponential(50),
nu ~ Exponential(0.1), a centred Gaussian random walk of log-volatilities
s_1 ~ N(0, sigma), s_t ~ N(s_{t-1}, sigma), and returns r_t ~ StudentT(nu,
0, exp(s_t)): T + 2 = 3,002 unconstrained latents a chain.  Not a GLM
family, so ``sample()`` differentiates the compiled log density (replayed
from a CUDA graph on the card)."""
from __future__ import annotations

import torch


def make_data(cfg: dict, row_seed: int, device) -> dict:
    """The fixed returns of ``data_seed``, drawn from the model at
    ``sigma_true`` and ``nu_true`` on the CPU (so every device holds the
    same series).  ``row_seed`` is not used: time is not permuted."""
    t, nu = cfg["num_rows"], int(cfg["nu_true"])
    g = torch.Generator().manual_seed(int(cfg["data_seed"]))
    s = torch.cumsum(cfg["sigma_true"] * torch.randn(t, generator=g, dtype=torch.float64), 0)
    chi2 = torch.randn(t, nu, generator=g, dtype=torch.float64).square().sum(-1)
    eps = torch.randn(t, generator=g, dtype=torch.float64) * torch.rsqrt(chi2 / nu)
    return {"r": (torch.exp(s) * eps).to(torch.float32).to(device)}


def build_model(cfg: dict, data: dict):
    import brancher_torch as BT
    import brancher_torch.functions as BF
    from brancher_torch.stochastic_processes import ARProcess

    sigma = BT.ExponentialVariable(cfg["sigma_rate"], "sigma")
    nu = BT.ExponentialVariable(cfg["nu_rate"], "nu")
    s = ARProcess(cfg["num_rows"], coefficients=1.0, noise_scale=sigma, name="s",
                  init_loc=0.0, init_scale=sigma)
    r = BT.StudentTVariable(nu, 0.0, BF.exp(s), "r")
    r.observe(data["r"])
    return BT.ProbabilisticModel([r])


def work(cfg: dict, chains: int, dim: int) -> dict:
    """Operations and bytes of one value+grad call over ``chains`` states,
    counted from the formula per (chain, t): the walk's increment, its
    standardisation and square (4 forward, 5 backward) and the StudentT's
    e^{-s}, residual, square, log1p and sums (8 forward, 7 backward), 24 in
    all, a transcendental counted as one; the least bytes: z read, the
    gradient and the value written, the returns read, 4 bytes each."""
    t = cfg["num_rows"]
    return {"flops": 24 * chains * t, "bytes": 4 * (2 * chains * dim + chains + t),
            "dtype": "f32"}
