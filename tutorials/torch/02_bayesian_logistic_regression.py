# %% [markdown]
# # Bayesian logistic regression: minibatching and the fused fast path
#
# This tutorial mirrors the reference's logistic-regression example
# (BASELINE config #2) and shows the two mechanisms behind it on the
# card: the `RandomIndices`/`EmpiricalVariable` data-loader pattern for
# minibatched SVI, and the fused value+grad kernel (hand-written CUDA for
# the H100) that the MCMC engines pick up automatically for GLM-shaped
# models.

# %%
import os

import numpy as np
import torch

from brancher_torch import config

FAST = bool(int(os.environ.get("TUTORIAL_FAST", "0")))
# Entry points run on the card ("cuda") unless told otherwise; the fast
# (CI) mode runs the whole tutorial on the CPU at reduced iteration counts
if FAST:
    config.device = "cpu"

# %% [markdown]
# ## 1. Data and model
#
# `w ~ N(0, I)`; `y_i ~ Bernoulli(sigmoid(x_i · w))`.  With
# `batch_size=...` the model wires a `RandomIndices` draw through two
# `EmpiricalVariable`s so every SVI step sees a fresh minibatch, and the
# likelihood rescales by N/B to stay unbiased.

# %%
from brancher_torch.models.logistic_regression import (
    logistic_regression_model,
    make_logreg_data,
)

n_points, dim = (200, 8) if FAST else (1000, 16)
x, y, w_true = make_logreg_data(num_points=n_points, dim=dim, seed=0)
model_full = logistic_regression_model(x, y)              # full-data
model_mini = logistic_regression_model(x, y, batch_size=64)  # minibatched
print(model_mini)

# %% [markdown]
# ## 2. Minibatched SVI

# %%
from brancher_torch.inference import perform_inference

res = perform_inference(
    model_mini,
    number_iterations=300 if FAST else 2000,
    number_samples=8,
    lr=0.02,
    key=0,
)
gen = torch.Generator(device=config.device).manual_seed(1)
zs, _ = res.guide.sample_and_log_prob(res.params["q"], gen, 400, detach=True)
w_svi = zs["w"].mean(0).cpu().numpy()
print(f"corr(SVI mean, true w) = {np.corrcoef(w_svi, w_true)[0, 1]:.3f}")

# %% [markdown]
# ## 3. NUTS with the auto-fused potential
#
# `sample()` numerically probes the compiled model; logistic regression
# matches the `bernoulli_logit` GLM family, so the potential's value AND
# gradient evaluate in one fused kernel (the two products of a leapfrog
# step across the whole chain block).  Models that don't match keep
# vmapped autodiff (replayed from a CUDA graph on the card) — the probe
# self-checks values and gradients against the autodiff density before it
# is trusted.

# %%
from brancher_torch.inference import sample, NUTS

mcmc = sample(
    model_full,
    kernel=NUTS(max_depth=8),
    num_samples=300 if FAST else 1000,
    num_warmup=300 if FAST else 1000,
    num_chains=16,
    key=2,
)
print("fused family:", mcmc.diagnostics["fused_family"])
w_nuts = mcmc.samples["w"].reshape(-1, dim).mean(0).cpu().numpy()
print(f"corr(NUTS mean, true w) = {np.corrcoef(w_nuts, w_true)[0, 1]:.3f}")
print(f"corr(NUTS mean, SVI mean) = {np.corrcoef(w_nuts, w_svi)[0, 1]:.3f}")

# %% [markdown]
# ## 4. Posterior predictive checks

# %%
ppc = mcmc.posterior_predictive(model_full, num_draws=50, key=3)
acc = (ppc["y"].float().mean(0).round().cpu().numpy() == y).mean()
print(f"posterior-predictive agreement with data: {acc:.2%}")

# %% [markdown]
# On the card the same call at 1024 chains is `chip_smoke.py`'s floor
# configuration; `PERF.md` holds its measured throughput.
