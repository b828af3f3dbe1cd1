# %% [markdown]
# # Particle variational inference: Wasserstein and Stein
#
# The reference's research-flavored capability (Ambrogioni et al.):
# approximate the posterior with an ENSEMBLE of particles instead of a
# parametric family.  Two engines, one call:
#
# * `WassersteinVariationalGradientDescent` — true WVGD: the equal-weight
#   ensemble descends the W2 distance to the posterior by semi-discrete
#   optimal transport.  Each step draws an importance-weighted point
#   cloud, solves the transport plan with log-domain Sinkhorn (column
#   marginals exactly 1/P — the Laguerre-cell geometry `VoronoiSet`
#   exposes), and moves every particle toward its plan barycenter.
# * `SteinVariationalGradientDescent` — the kernelized SVGD flow
#   (grad-log-p drift + kernel repulsion).
#
# Everything is [P, d]-batched tensor work: cost matrices and cell
# statistics are matrix products, log-densities come from the compiled
# model.

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
# ## 1. Target: conjugate posterior with a known answer

# %%
from brancher_torch.models.conjugate import conjugate_normal_model

model, truth = conjugate_normal_model(num_obs=20)
print(f"exact posterior: mu = {truth['post_mean']:.3f}, "
      f"var = {truth['post_var']:.4f}")

# %% [markdown]
# ## 2. Wasserstein VGD

# %%
from brancher_torch.inference import perform_inference
from brancher_torch.inference.svi import (
    SteinVariationalGradientDescent,
    WassersteinVariationalGradientDescent,
)

res_w = perform_inference(
    model,
    number_iterations=200 if FAST else 800,
    inference_method=WassersteinVariationalGradientDescent(
        number_particles=64, proposal_scale=2.0),
    key=0,
)
pw = res_w.extras["particles"]["mu"].cpu().numpy()
print(f"WVGD:  mean = {pw.mean():.3f}, var = {pw.var():.4f}  "
      f"(transport cost {float(res_w.loss_curve[0]):.3f} -> {float(res_w.loss_curve[-1]):.4f})")

# %% [markdown]
# ## 3. Stein VGD on the same model

# %%
res_s = perform_inference(
    model,
    number_iterations=150 if FAST else 400,
    inference_method=SteinVariationalGradientDescent(number_particles=64),
    lr=0.05,
    key=1,
)
ps = res_s.extras["particles"]["mu"].cpu().numpy()
print(f"SVGD:  mean = {ps.mean():.3f}, var = {ps.var():.4f}")

# %% [markdown]
# Both ensembles quantize the posterior: the means match the closed form
# and the particle variances sit slightly below the true posterior
# variance (the usual equal-mass quantization shrinkage, vanishing as P
# grows).
#
# ## 4. Voronoi / Laguerre cells
#
# `VoronoiSet` is the reference's particle utility, extended with POWER
# weights: with weights psi the cells become the Laguerre cells of
# semi-discrete optimal transport (psi = Kantorovich duals), which is
# exactly how WVGD balances mass across particles.

# %%
from brancher_torch.inference.particle_inference_tools import VoronoiSet

centers = torch.tensor([[0.0], [2.0]])
pts = torch.tensor([[0.9], [1.1], [1.9]])
plain = VoronoiSet(centers)
powered = VoronoiSet(centers, power=torch.tensor([4.0, 0.0]))
print("plain assignment:  ", plain.assign(pts).numpy())
print("powered assignment:", powered.assign(pts).numpy(),
      " (the weighted center claims more territory)")
