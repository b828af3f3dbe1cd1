# %% [markdown]
# # Variational autoencoder: neural networks inside the DSL
#
# The reference's flagship deep-generative example (BASELINE config #5):
# `torch.nn.Module`s lift into the graph through `BF.BrancherFunction`,
# the encoder reads the same minibatch variable the likelihood is
# conditioned on (amortization by construction), and every SVI step is
# one batched pass on the card.

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
# ## 1. Model + amortized guide
#
# `vae_model` builds p and q: `z ~ N(0, I)`; `x ~ Bernoulli(dec(z))`
# observed through a minibatch loader; `q(z|x) = N(enc_mu(x),
# exp(enc_logsig(x)))`.  Both per-datapoint terms carry the N/B scale so
# the minibatch ELBO is unbiased for the full dataset.

# %%
from brancher_torch.models.vae import VAEConfig, make_vae_data, vae_model
from brancher_torch.inference import perform_inference

data = make_vae_data(num_points=1024 if FAST else 4096, obs_dim=64)
p_model, q_model = vae_model(
    data, VAEConfig(latent_dim=8, hidden_dim=64 if FAST else 128,
                    batch_size=128)
)
print(p_model)

# %% [markdown]
# ## 2. Train
#
# The guide was attached with `set_posterior_model`, so
# `perform_inference` uses it automatically; the parameters of the
# encoder and decoder modules register in the parameter store and train
# together.

# %%
res = perform_inference(
    p_model,
    number_iterations=200 if FAST else 1500,
    number_samples=4,
    lr=1e-3,
    key=0,
)
print(f"-ELBO: {float(res.loss_curve[0]):.0f} -> {float(res.loss_curve[-1]):.0f}")
assert res.loss_curve[-1] < res.loss_curve[0]

# %% [markdown]
# ## 3. Reconstruction check
#
# The networks are plain `torch.nn.Module`s (`Linear`, ReLU, `Linear`),
# called with `torch.func.functional_call` on the weights of the
# parameter store: the trained weights sit in the result's parameter tree
# under the function's name.  Sample the posterior through the joint and
# compare the reconstructions against the inputs.

# %%
dec_params = res.params["p"]["decoder__params"]
print("decoder weights:", {k: tuple(v.shape) for k, v in dec_params.items()})
post = p_model.get_posterior_sample_dict(
    64, key=1, params={"p": res.params["p"], "q": res.params["q"]},
)
xb, xhat = post["xb"].cpu().numpy(), post["x"].cpu().numpy()
agree = (xhat.round() == xb).mean()
print(f"reconstruction agreement on a fresh minibatch: {agree:.2%}")

# %% [markdown]
# `chip_smoke.py` phase 10 trains this model at B=256 on the card and
# `PERF.md` holds its measured ELBO steps per second.
