# %% [markdown]
# # Getting started with brancher_torch
#
# `brancher_torch` is the PyTorch / CUDA port of `brancher_tpu`: the same
# symbolic random-variable DSL of
# [Brancher](https://github.com/LucaAmbrogioni/Brancher), where you build
# models by composing variables with ordinary Python arithmetic, and every
# inference engine (SVI, NUTS/HMC, SMC, particle methods) consumes the
# SAME model, compiled once into PyTorch functions that run on an NVIDIA
# card.
#
# This tutorial covers the core workflow: define → observe → infer →
# inspect, on a conjugate model where every answer is known in closed
# form.

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
# ## 1. Building a model
#
# Variables compose with `+ - * / @ **` and the lifted math namespace
# `BF.*`; parents are discovered automatically.  Nothing executes yet —
# the graph is data, lowered to PyTorch closures on first use.

# %%
from brancher_torch import NormalVariable, LogNormalVariable, ProbabilisticModel
import brancher_torch.functions as BF

mu = NormalVariable(0.0, 2.0, "mu")            # latent mean
sigma = LogNormalVariable(0.0, 0.25, "sigma")  # latent noise scale
x = NormalVariable(mu, sigma, "x", plate_shape=(30,))  # 30 iid points

rng = np.random.RandomState(0)
data = (2.0 + 0.4 * rng.randn(30)).astype(np.float32)
x.observe(data)

model = ProbabilisticModel([x])
print(model)

# %% [markdown]
# ## 2. Forward sampling
#
# `get_sample` returns a tidy pandas DataFrame (the reference API);
# `get_sample_dict` returns raw tensors.  A `key` is an int seed or a
# `torch.Generator` on the run's device.

# %%
df = model.get_sample(5, key=0)
print(df[["mu", "sigma"]].round(3))

# %% [markdown]
# ## 3. Stochastic variational inference
#
# With no guide specified, `perform_inference` builds an automatic
# mean-field Normal over the unconstrained latents and minimizes the
# negative ELBO with reparameterized gradients.

# %%
from brancher_torch.inference import perform_inference

res = perform_inference(
    model,
    number_iterations=200 if FAST else 1500,
    number_samples=16,
    lr=0.05,
    key=1,
)
gen = torch.Generator(device=config.device).manual_seed(2)
zs, _ = res.guide.sample_and_log_prob(res.params["q"], gen, 500, detach=True)
print(f"SVI posterior:  mu = {float(zs['mu'].mean()):.3f} "
      f"± {float(zs['mu'].std()):.3f}")

# %% [markdown]
# ## 4. NUTS
#
# The same model runs Hamiltonian Monte Carlo.  The default engine is the
# chain-batched vectorized NUTS: all chains advance in lockstep, so every
# leapfrog step is a single batched gradient evaluation over the chains.

# %%
from brancher_torch.inference import sample, NUTS

mcmc = sample(
    model,
    kernel=NUTS(),
    num_samples=300 if FAST else 1000,
    num_warmup=600 if FAST else 1000,  # the Stan-style warmup windows
    # need some room: very short warmups can leave chains stuck in the
    # stiff tails of the uniform(-2,2) init
    num_chains=8,
    key=3,
)
print(f"NUTS posterior: mu = {float(mcmc.samples['mu'].mean()):.3f} "
      f"± {float(mcmc.samples['mu'].std()):.3f}")
print(f"diagnostics: R-hat = {float(mcmc.diagnostics['r_hat']['mu']):.4f}, "
      f"min ESS = {float(np.min(mcmc.diagnostics['ess']['mu'])):.0f}, "
      f"divergences = {int(mcmc.diagnostics['num_divergences'])}")

# %% [markdown]
# ## 5. Checking against the closed form
#
# For this conjugate-ish model the marginal posterior of `mu` given the
# data and the true noise scale is Normal; both engines should agree with
# it (and with each other) within Monte-Carlo error.

# %%
prior_var, noise_var = 4.0, 0.16
post_prec = 1 / prior_var + len(data) / noise_var
post_mean = (data.sum() / noise_var) / post_prec
print(f"closed form (at true sigma): mu ≈ {post_mean:.3f} "
      f"± {np.sqrt(1/post_prec):.3f}")

# %% [markdown]
# ## Where to go next
#
# * `02_bayesian_logistic_regression` — minibatched data loaders and the
#   fused-potential fast path (a hand-written CUDA kernel on the card).
# * `03_vae` — amortized inference with `torch.nn` networks inside the DSL.
# * `04_flow_vi` — normalizing-flow variational families.
# * `05_wvgd` — particle-based variational inference (Wasserstein and
#   Stein variants).
