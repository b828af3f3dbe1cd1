# %% [markdown]
# # Reparameterizing hierarchies: non-centered models and funnels
#
# Hierarchical scale models — `w ~ N(0, tau)` with `tau` itself random —
# produce *funnel* posteriors: as `tau` shrinks, the conditional density
# of `w` concentrates into an ever-narrower neck that no single HMC step
# size can integrate.  The symptoms are **divergences** (energy errors
# above the sampler's threshold) and sticky `tau` chains.
#
# The classic fix is the *non-centered parameterization*: sample
# `w_raw ~ N(0, 1)` and define `w = tau * w_raw` deterministically.  The
# joint distribution is identical, but the sampler now moves in a
# well-conditioned standard-normal space.  `brancher_torch` packages this
# as `NonCenteredNormalVariable`:
#
# * it creates the `N(0, 1)` latent (`<name>_raw`, exposed as `.raw`),
# * returns the deterministic centered node, which shows up in
#   `sample()` outputs like any other variable,
# * and `sample(..., ess_vars=[...])` extends ESS / R-hat diagnostics to
#   that deterministic node, so you score the quantity you care about.
#
# This is the transformation behind the ARD headline that
# `chip_smoke.py` phase 8 samples on the card.

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
# ## 1. An ARD logistic regression, centered
#
# Automatic relevance determination: each weight gets its own scale
# `tau_j ~ LogNormal(0, 1.5)`, and the data is deliberately weak
# (N=100) so the posterior keeps the prior's funnel geometry.

# %%
import brancher_torch.functions as BF
from brancher_torch import (
    BernoulliVariable,
    LogNormalVariable,
    NonCenteredNormalVariable,
    NormalVariable,
    ProbabilisticModel,
)
from brancher_torch.inference import NUTS, sample

DIM = 8 if FAST else 16
N = 100
rng = np.random.RandomState(0)
x_data = rng.standard_normal((N, DIM)).astype(np.float32)
w_true = (rng.standard_normal(DIM) * (rng.uniform(size=DIM) < 0.3)).astype(
    np.float32
)
y_data = (
    rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-x_data @ w_true))
).astype(np.float32)

tau = LogNormalVariable(torch.zeros(DIM), 1.5 * torch.ones(DIM), "tau")
w = NormalVariable(torch.zeros(DIM), tau, "w")  # CENTERED: w ~ N(0, tau)
yv = BernoulliVariable(logits=BF.matmul(torch.as_tensor(x_data), w), name="y")
yv.observe(y_data)
centered = ProbabilisticModel([yv])

kw = dict(
    kernel=NUTS(max_depth=8),
    num_samples=300 if FAST else 1000,
    num_warmup=300 if FAST else 600,
    num_chains=8,
    key=0,
    target_accept=0.9,
)
res_c = sample(centered, **kw)
cap = kw["num_chains"] * kw["num_samples"]
ess_c = np.concatenate([
    np.ravel(res_c.diagnostics["ess"][n]) for n in ("w", "tau")
])
print(f"centered:     divergences={int(res_c.diagnostics['num_divergences'])}"
      f"  min ESS={ess_c.min():.0f} of {cap}"
      f"  max R-hat={max(float(np.max(res_c.diagnostics['r_hat'][n])) for n in ('w', 'tau')):.3f}")

# %% [markdown]
# ## 2. The same model, non-centered
#
# One line changes: `NormalVariable(0, tau)` becomes
# `NonCenteredNormalVariable(0, tau, shape=(DIM,))`.  The sampler now
# sees latents `tau` and `w_raw`; `w` is reconstructed deterministically
# and still appears in the output samples.  `ess_vars=["w", "tau"]`
# scores the physical quantities, not the raw coordinates.

# %%
tau2 = LogNormalVariable(torch.zeros(DIM), 1.5 * torch.ones(DIM), "tau")
w2 = NonCenteredNormalVariable(0.0, tau2, name="w", shape=(DIM,))
yv2 = BernoulliVariable(logits=BF.matmul(torch.as_tensor(x_data), w2), name="y")
yv2.observe(y_data)
noncentered = ProbabilisticModel([yv2])

res_n = sample(noncentered, ess_vars=["w", "tau"], **kw)
ess_n = np.concatenate([
    np.ravel(res_n.diagnostics["ess"][n]) for n in ("w", "tau")
])
print(f"non-centered: divergences={int(res_n.diagnostics['num_divergences'])}"
      f"  min ESS={ess_n.min():.0f} of {cap}"
      f"  max R-hat={max(float(np.max(res_n.diagnostics['r_hat'][n])) for n in ('w', 'tau')):.3f}")

# %% [markdown]
# ## 3. Same posterior, different geometry — and who to believe
#
# Both parameterizations target the identical joint, and the
# well-identified `w` means agree closely.  `tau` is where divergences
# *bias* the centered estimate: the funnel neck (small `tau`) is
# exactly the region the centered sampler bounces off of, so its `tau`
# posterior mean is shifted upward.  The non-centered run — zero-ish
# divergences, clean R-hat — is the trustworthy one; the gap below is
# the size of the bias you would have silently accepted.

# %%
for name in ("w", "tau"):
    mc = res_c.samples[name].reshape(-1, DIM).mean(0).cpu().numpy()
    mn = res_n.samples[name].reshape(-1, DIM).mean(0).cpu().numpy()
    print(f"{name}: max |centered - noncentered| posterior-mean gap "
          f"= {np.abs(mc - mn).max():.3f}")

# the sampled latent really is the raw coordinate
print("z-space latents:", sorted(noncentered.compiled().continuous_latent_names))

# %% [markdown]
# ## 4. When to use which
#
# * **Non-centered** wins when the data is weak relative to the prior
#   hierarchy (the funnel survives into the posterior) — small groups,
#   sparse regression, eight-schools-style meta-analysis.
# * **Centered** wins when the data strongly identifies each `w_j`
#   (the funnel flattens; the extra deterministic indirection then just
#   adds latent dimensions).
# * Divergence counts are the decision signal: a handful per thousand
#   draws means the geometry, not the step size, is the problem.
#
# `NonCenteredNormalVariable(loc, scale, name, shape=)` accepts any
# variable/expression for `loc` and `scale`, infers `shape` from
# concrete arrays when omitted, and names the raw latent
# `f"{name}_raw"` (override with `raw_name=`).
