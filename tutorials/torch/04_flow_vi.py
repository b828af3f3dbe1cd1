# %% [markdown]
# # Flow-based variational inference
#
# Mean-field guides cannot represent correlated or skewed posteriors.
# `brancher_torch` offers two richer variational families:
#
# * **DSL flows** — `TransformedVariable` pushes a Normal base through a
#   stack of invertible maps (`TriangularLinear`, `Shift`, `PlanarFlow`,
#   `Sigmoid`); sampling and density are fused along the sampling path,
#   and the flow parameters register as learnable leaves automatically.
# * **AutoIAF** — an inverse-autoregressive-flow guide over the flat
#   unconstrained latent vector (MADE-masked dense layers: everything is
#   a dense product, which is what the card's matrix units want).
#
# We fit both to a banana-shaped posterior and compare against NUTS.

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
# ## 1. A correlated target
#
# `a ~ N(0,1)`, `b ~ N(a^2, 0.5)`, observed noisy `y = b + eps`: the
# joint posterior over `(a, b)` is banana-shaped — poison for mean-field.

# %%
from brancher_torch import NormalVariable, ProbabilisticModel
import brancher_torch.functions as BF

a = NormalVariable(0.0, 1.0, "a")
b = NormalVariable(a * a, 0.5, "b")
y = NormalVariable(b, 0.3, "y", plate_shape=(5,))
rng = np.random.RandomState(0)
y.observe((1.0 + 0.3 * rng.randn(5)).astype(np.float32))
model = ProbabilisticModel([y])

# %% [markdown]
# ## 2. Ground truth via NUTS

# %%
from brancher_torch.inference import sample, NUTS, perform_inference

mcmc = sample(model, kernel=NUTS(), num_samples=400 if FAST else 2000,
              num_warmup=400 if FAST else 1000, num_chains=8, key=0)
ref_a = mcmc.samples["a"].cpu().numpy().ravel()
ref_b = mcmc.samples["b"].cpu().numpy().ravel()
print(f"NUTS:      E[a]={ref_a.mean():+.3f}  sd[a]={ref_a.std():.3f}  "
      f"E[b]={ref_b.mean():+.3f}  corr(a^2,b)={np.corrcoef(ref_a**2, ref_b)[0,1]:.2f}")

# %% [markdown]
# ## 3. Mean-field baseline vs AutoIAF
#
# Same `perform_inference` call; only the guide changes.

# %%
from brancher_torch.inference.guides import AutoMeanField, AutoIAF

comp = model.compiled()
iters = 400 if FAST else 3000
for name, guide in (("mean-field", AutoMeanField(comp)),
                    ("AutoIAF", AutoIAF(comp, num_flows=2, hidden=32))):
    res = perform_inference(model, number_iterations=iters, number_samples=16,
                            lr=5e-3, guide=guide, key=1)
    gen = torch.Generator(device=config.device).manual_seed(2)
    with torch.no_grad():
        zs, _ = guide.sample_and_log_prob(res.params["q"], gen, 2000)
    qa, qb = zs["a"].cpu().numpy().ravel(), zs["b"].cpu().numpy().ravel()
    print(f"{name:>10}:  E[a]={qa.mean():+.3f}  sd[a]={qa.std():.3f}  "
          f"E[b]={qb.mean():+.3f}  corr(a^2,b)={np.corrcoef(qa**2, qb)[0,1]:.2f}  "
          f"final -ELBO={float(res.loss_curve[-1]):.3f}")

# %% [markdown]
# The posterior over `a` is BIMODAL (a ≈ ±1 both explain b ≈ 1): NUTS
# averages the two symmetric modes to E[a] ≈ 0 while each variational
# fit commits to one mode — compare the single-mode sd and the curvature
# statistic `corr(a², b)` instead, which the IAF guide reproduces and
# mean-field structurally cannot (it also reaches a lower -ELBO).
#
# ## 4. DSL flows: a flow-transformed guide you build by hand
#
# `TransformedVariable` is a regular DSL variable, so a flow guide is
# just another ProbabilisticModel passed as the posterior model.

# %%
from brancher_torch.transformations import (
    PlanarFlow, Shift, TransformedVariable, TriangularLinear,
)

qa_flow = TransformedVariable("a", dim=1,
                              flows=[TriangularLinear(), Shift(), PlanarFlow()])
qb_flow = TransformedVariable("b", dim=1,
                              flows=[TriangularLinear(), Shift(), PlanarFlow()])
q_model = ProbabilisticModel([qa_flow, qb_flow])
res = perform_inference(model, number_iterations=iters, number_samples=16,
                        lr=5e-3, posterior_model=q_model, key=3)
qs = q_model.get_sample_dict(2000, key=4, params=res.params["q"])
qa = qs["a"].detach().cpu().numpy().ravel()
print(f"DSL planar-flow guide: E[a]={qa.mean():+.3f} sd[a]={qa.std():.3f} "
      f"final -ELBO={float(res.loss_curve[-1]):.3f}")
