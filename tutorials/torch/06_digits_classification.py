# %% [markdown]
# # Handwritten-digit classification: the MNIST-class demo
#
# The reference's example gallery ends with MNIST softmax classifiers
# (SURVEY.md §2 "Examples").  This tutorial is the same demo on
# scikit-learn's bundled 8x8 digits (no download needed, but scikit-learn
# must be installed): first a maximum-likelihood softmax classifier
# trained through the `RandomIndices`/`EmpiricalVariable` minibatch
# loader, then the full BAYESIAN version — NUTS over all 650 weight
# coordinates — on the structure-preserving categorical potential that the
# GLM recognizer finds (`ops/glm.py::CategoricalFusedFamily`; NUTS keeps
# autodiff for it, as the JAX package does).

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
# ## 1. Data
#
# 1,797 8x8 grayscale digits, 10 classes.  We hold out 300 for test.

# %%
from sklearn.datasets import load_digits

digits = load_digits()
x_all = (digits.data / 16.0).astype(np.float32)
y_all = digits.target.astype(np.int32)
rng = np.random.RandomState(0)
perm = rng.permutation(len(x_all))
x_tr, y_tr = x_all[perm[:-300]], y_all[perm[:-300]]
x_te, y_te = x_all[perm[-300:]], y_all[perm[-300:]]
n, d, k = x_tr.shape[0], x_tr.shape[1], 10
print(f"train {x_tr.shape}, test {x_te.shape}")

# %% [markdown]
# ## 2. Maximum-likelihood softmax with minibatches
#
# Learnable weights are `DeterministicVariable(..., learnable=True)`
# leaves; `RandomIndices` + `EmpiricalVariable` resample a fresh
# minibatch inside every SVI step, and `log_prob_scale=N/B` keeps the
# likelihood unbiased.

# %%
import brancher_torch.functions as BF
from brancher_torch import (
    CategoricalVariable, DeterministicVariable, EmpiricalVariable,
    ProbabilisticModel, RandomIndices,
)
from brancher_torch.inference import MaximumLikelihood, perform_inference

batch = 256
idx = RandomIndices(n, batch, "idx")
xb = EmpiricalVariable(x_tr, name="xb", indices=idx)
yb = EmpiricalVariable(y_tr, name="yb", indices=idx)
w = DeterministicVariable(np.zeros((d, k), np.float32), "w", learnable=True)
b = DeterministicVariable(np.zeros(k, np.float32), "b", learnable=True)
y = CategoricalVariable(logits=BF.matmul(xb, w) + b, name="y",
                        log_prob_scale=float(n) / batch)
y.observe(yb)
ml_model = ProbabilisticModel([y])

res = perform_inference(
    ml_model, number_iterations=200 if FAST else 1200, number_samples=1,
    lr=0.05, inference_method=MaximumLikelihood(), key=0,
)
w_hat = res.params["p"]["w"].detach().cpu().numpy()
b_hat = res.params["p"]["b"].detach().cpu().numpy()
acc = ((x_te @ w_hat + b_hat).argmax(-1) == y_te).mean()
print(f"NLL {float(res.loss_curve[0]):.0f} -> {float(res.loss_curve[-1]):.0f}; "
      f"test accuracy {acc:.3f}")

# %% [markdown]
# ## 3. Bayesian softmax: NUTS over 650 coordinates
#
# Put Gaussian priors on `w` and `b` and sample the exact posterior.
# The numeric recognizer probes the compiled model and discovers the
# `logits = X @ W(z) + c` structure.  On a subset so the tutorial stays
# quick; posterior-mean accuracy matches ML while also giving calibrated
# class probabilities.

# %%
from brancher_torch import NormalVariable
from brancher_torch.inference import NUTS, sample

n_sub = 150 if FAST else 500
wv = NormalVariable(torch.zeros((d, k)), torch.ones((d, k)), "w")
bv = NormalVariable(torch.zeros(k), 2.0 * torch.ones(k), "b")
yv = CategoricalVariable(logits=BF.matmul(torch.as_tensor(x_tr[:n_sub]), wv) + bv, name="y")
yv.observe(y_tr[:n_sub])
bayes_model = ProbabilisticModel([yv])

res_mcmc = sample(
    bayes_model, kernel=NUTS(max_depth=6),
    num_samples=100 if FAST else 400, num_warmup=100 if FAST else 400,
    num_chains=4, key=1,
)
w_post = res_mcmc.samples["w"].mean((0, 1)).cpu().numpy()
b_post = res_mcmc.samples["b"].mean((0, 1)).cpu().numpy()
acc_b = ((x_te @ w_post + b_post).argmax(-1) == y_te).mean()
print(f"posterior-mean test accuracy {acc_b:.3f}; "
      f"divergences {int(res_mcmc.diagnostics['num_divergences'])}")

# %% [markdown]
# ## 4. Predictive uncertainty
#
# Averaging softmax probabilities over posterior draws gives a
# predictive distribution whose confidence is meaningful: accuracy on
# the most-confident test digits should be near-perfect, and lowest on
# the least-confident ones.

# %%
draws = res_mcmc.samples["w"].reshape(-1, d, k)[::8].cpu().numpy()
bs = res_mcmc.samples["b"].reshape(-1, k)[::8].cpu().numpy()
logits = np.einsum("nd,sdk->snk", x_te, draws) + bs[:, None, :]
probs = np.exp(logits - logits.max(-1, keepdims=True))
probs /= probs.sum(-1, keepdims=True)
pred_p = probs.mean(0)  # [n_test, K] posterior-predictive
conf = pred_p.max(-1)
order = np.argsort(-conf)
top, bottom = order[:100], order[-100:]
acc_top = (pred_p.argmax(-1)[top] == y_te[top]).mean()
acc_bot = (pred_p.argmax(-1)[bottom] == y_te[bottom]).mean()
print(f"accuracy @100 most-confident: {acc_top:.3f}; "
      f"@100 least-confident: {acc_bot:.3f}")
