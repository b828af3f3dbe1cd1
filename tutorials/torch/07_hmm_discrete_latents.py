# %% [markdown]
# # Hidden Markov models and discrete latents
#
# The reference handles discrete latent variables through relaxations
# (Concrete/Gumbel-softmax) or score-function gradients.
# `brancher_torch` additionally marginalizes them EXACTLY, three ways:
#
# 1. **`EmissionHMMVariable`** — a first-class HMM series whose latent
#    state chain is summed out by a log-space forward algorithm, so NUTS
#    runs on the emission/transition parameters as if the model were
#    fully continuous.
# 2. **Element-wise enumeration** — independent Bernoulli/Categorical
#    latents (mixture assignments) are summed out with one batch of
#    density evaluations (`enumerate_discrete=True`).
# 3. **Structural enumeration** — *interacting* discrete latents built
#    directly in the DSL are analyzed structurally (each log-prob term's
#    discrete support is read off the graph): state-to-state chains get
#    a sum-product forward pass over locally evaluated pairwise factors,
#    and arbitrary scalar interaction patterns (colliders, non-adjacent
#    pairs) fall back to exact variable elimination in min-fill order.
#
# This tutorial walks through all three, plus posterior decoding
# (forward-backward smoothing and Viterbi MAP paths).

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
# ## 1. A Gaussian HMM, NUTS over its emission parameters
#
# Generate a 2-state sequence, then treat the state means as unknown
# with the states never entering the sampler: the `EmissionHMM`
# distribution's `log_prob` IS the marginal likelihood.

# %%
from brancher_torch import NormalVariable, ProbabilisticModel
from brancher_torch.distributions import Normal
from brancher_torch.stochastic_processes import EmissionHMM, EmissionHMMVariable
from brancher_torch.inference import NUTS, sample

T = 60 if FAST else 120
rng = np.random.RandomState(0)
trans = np.asarray([[0.92, 0.08], [0.15, 0.85]])
true_locs = np.asarray([-2.0, 2.0])
s, ys, states = 0, [], []
for _ in range(T):
    states.append(s)
    ys.append(true_locs[s] + 0.7 * rng.randn())
    s = rng.choice(2, p=trans[s])
ys = np.asarray(ys, np.float32)
states = np.asarray(states)

locs = NormalVariable(torch.zeros(2), 3.0, "locs")
y = EmissionHMMVariable(
    T, Normal(),
    init_logits=torch.zeros(2),
    trans_logits=torch.log(torch.as_tensor(trans, dtype=torch.float32)),
    loc=locs, scale=torch.full((2,), 0.7), name="y",
)
y.observe(ys)
model = ProbabilisticModel([y])

res = sample(model, kernel=NUTS(max_depth=6),
             num_samples=100 if FAST else 400,
             num_warmup=100 if FAST else 400, num_chains=2, key=0)
locs_hat = np.sort(res.samples["locs"].reshape(-1, 2).mean(0).cpu().numpy())
print("posterior emission means:", locs_hat.round(2), "(true -2, 2)")

# %% [markdown]
# ## 2. Posterior decoding: smoothing marginals and the Viterbi path
#
# With parameters inferred, decode the hidden states two ways:
# `posterior_marginals` (forward-backward, per-step probabilities) and
# `viterbi` (max-product MAP path).

# %%
hmm = EmissionHMM(T, Normal())
dec_params = dict(
    init_logits=torch.zeros(2),
    trans_logits=torch.log(torch.as_tensor(trans, dtype=torch.float32)),
    emission_loc=torch.as_tensor(locs_hat, dtype=torch.float32),
    emission_scale=torch.full((2,), 0.7),
)
gamma = hmm.posterior_marginals(torch.as_tensor(ys), **dec_params).numpy()  # [T, 2]
path = hmm.viterbi(torch.as_tensor(ys), **dec_params).numpy()  # [T]
print("smoothing accuracy:", round(float((gamma.argmax(1) == states).mean()), 3))
print("viterbi accuracy:  ", round(float((path == states).mean()), 3))

# %% [markdown]
# ## 3. Mixture assignments: element-wise enumeration
#
# Independent categorical latents (one per data point) marginalize with
# `enumerate_discrete=True` — no relaxation, no score-function variance.

# %%
import brancher_torch.functions as BF
from brancher_torch import CategoricalVariable

n = 30
comp = rng.randint(0, 2, n)
data = (np.asarray([-2.0, 2.0])[comp] + 0.5 * rng.randn(n)).astype(np.float32)

mu = NormalVariable(torch.zeros(2), 3.0 * torch.ones(2), "mu")
zc = CategoricalVariable(probs=torch.ones(2) / 2, name="z", plate_shape=(n,))
xm = NormalVariable(BF.take(mu, zc), 0.5, "x")
xm.observe(data)
mix = ProbabilisticModel([xm])

res_mix = sample(mix, kernel=NUTS(max_depth=6),
                 num_samples=100 if FAST else 300,
                 num_warmup=100 if FAST else 300, num_chains=2,
                 key=1, enumerate_discrete=True)
mu_hat = np.sort(res_mix.samples["mu"].reshape(-1, 2).cpu().numpy(), axis=1).mean(0)
print("mixture means:", mu_hat.round(2), "(true -2, 2)")

# %% [markdown]
# The per-point assignment posterior comes back from the same machinery:

# %%
cm = mix.compiled()
_, resp = cm.enumerated_log_density(
    cm.initial_params, {"mu": torch.as_tensor(mu_hat, device=cm.device)},
    return_responsibilities=True)
hard = resp["z"].argmax(-1).cpu().numpy()
acc = max((hard == comp).mean(), ((1 - hard) == comp).mean())
print("assignment accuracy:", round(float(acc), 3))

# %% [markdown]
# ## 4. Interacting discrete latents straight from the DSL
#
# States wired explicitly — `s_t ~ Cat(A[s_{t-1}])` — interact, so the
# element-wise factorization fails.  `sample(...,
# enumerate_discrete=True)` reads the pairwise chain off the graph
# structurally and switches to a forward-algorithm marginalizer over
# locally evaluated factors automatically (models that are not chains —
# colliders, non-adjacent interactions — get exact variable elimination
# instead).

# %%
Tc = 8 if FAST else 12
A = torch.as_tensor(trans, dtype=torch.float32)
off = NormalVariable(0.0, 3.0, "off")
sv = CategoricalVariable(probs=torch.tensor([0.5, 0.5]), name="s0")
chain = [sv]
for t in range(1, Tc):
    sv = CategoricalVariable(probs=BF.take(A, sv, axis=0), name=f"s{t}")
    chain.append(sv)
outs = []
for t, st in enumerate(chain):
    xo = NormalVariable(2.0 * (2.0 * st - 1.0) + off, 0.7, f"x{t}")
    xo.observe(np.asarray(ys[t]))
    outs.append(xo)
dsl_hmm = ProbabilisticModel(outs)

cdsl = dsl_hmm.compiled()
print("element-wise factorization:",
      cdsl.check_enum_factorization(cdsl.initial_params))
print("pairwise-chain factorization:",
      cdsl.check_chain_factorization(cdsl.initial_params))

res_chain = sample(dsl_hmm, kernel=NUTS(max_depth=6),
                   num_samples=50 if FAST else 200,
                   num_warmup=50 if FAST else 200, num_chains=2,
                   key=2, enumerate_discrete=True)
print("emission offset posterior mean:",
      round(float(res_chain.samples["off"].mean()), 3))

# %% [markdown]
# The chain marginalizer also exposes smoothing marginals per state:

# %%
_, marg = cdsl.chain_enumerated_log_density(
    cdsl.initial_params,
    {"off": torch.tensor(float(res_chain.samples["off"].mean()), device=cdsl.device)},
    return_marginals=True)
decoded = np.asarray([float(marg[f"s{t}"][1]) for t in range(Tc)]) > 0.5
print("DSL-chain decode accuracy:",
      round(float((decoded == states[:Tc]).mean()), 3))

# %% [markdown]
# ## Summary
#
# * `EmissionHMMVariable(length, emission, ...)` — first-class HMM series
#   with any emission family; exact forward-algorithm likelihood,
#   `posterior_marginals`, `viterbi`.
# * `sample(model, enumerate_discrete=True)` — exact marginalization of
#   Bernoulli/Categorical latents: element-wise when independent, a
#   sum-product forward pass when they form a Markov chain.
# * The same dispatch powers SVI:
#   `ReverseKL(enumerate_discrete=True)`.
