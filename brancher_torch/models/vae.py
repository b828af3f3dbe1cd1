"""Variational autoencoder with an amortized guide (BASELINE config #5).

Counterpart of ``brancher_tpu/models/vae.py``: the same data generator
(numpy, copied) and the same model.  The flax ``Decoder``/``Encoder`` are
``MLP`` here, ``Linear(in, hidden)``, ReLU, ``Linear(hidden, out)``, with
the flax layer names (``Dense_0``, ``Dense_1``) so that
``bridge.params_to_torch`` carries JAX's params across.  nn.Linear's
weight is flax's kernel transposed, and its default initialisation is not
flax's: the modules are made under a fixed seed, so a model's initial
params are the same on every build, but not JAX's.

The guide REUSES the model's data-loader variables (RandomIndices +
EmpiricalVariable) by object identity; the SVI engine feeds the same
minibatch draw to both p and q each step, which is what makes the guide
amortized (q(z | x_batch)).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import functions as BF
from ..standard_variables import (
    BernoulliVariable,
    EmpiricalVariable,
    NormalVariable,
    RandomIndices,
)
from ..variables import ProbabilisticModel


class VAEConfig(NamedTuple):
    latent_dim: int = 8
    hidden_dim: int = 64
    batch_size: int = 128


def make_vae_data(num_points: int = 2048, obs_dim: int = 64, true_latent: int = 4,
                  seed: int = 0) -> np.ndarray:
    """Synthetic binarized data on a low-dimensional manifold."""
    rng = np.random.RandomState(seed)
    w = rng.normal(0, 1.5, size=(true_latent, obs_dim))
    z = rng.normal(0, 1, size=(num_points, true_latent))
    probs = 1.0 / (1.0 + np.exp(-(z @ w)))
    return (rng.uniform(size=probs.shape) < probs).astype(np.float32)


class MLP(torch.nn.Module):
    """Dense(hidden), ReLU, Dense(out): the JAX package's Decoder and Encoder."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(in_dim, hidden)
        self.Dense_1 = torch.nn.Linear(hidden, out)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def vae_model(
    data: np.ndarray,
    config: VAEConfig = VAEConfig(),
) -> Tuple[ProbabilisticModel, ProbabilisticModel]:
    """Returns (p_model, q_model) sharing data-loader variables."""
    n, obs_dim = data.shape
    b, latent, hidden = config.batch_size, config.latent_dim, config.hidden_dim
    with torch.random.fork_rng(devices=[]):  # the same initial weights on every build
        torch.manual_seed(0)
        decoder_net, mu_net, logsig_net = (MLP(latent, hidden, obs_dim), MLP(obs_dim, hidden, latent),
                                           MLP(obs_dim, hidden, latent))

    idx = RandomIndices(n, b, "idx")
    xb = EmpiricalVariable(torch.as_tensor(np.asarray(data, np.float32)), name="xb", indices=idx)

    # p(z) p(x|z); every per-datapoint term scales by N/B so the
    # minibatch ELBO is an unbiased estimate of the full-data ELBO
    z = NormalVariable(torch.zeros((b, latent)), torch.ones((b, latent)), "z",
                       log_prob_scale=float(n) / float(b))
    decoder = BF.BrancherFunction(decoder_net, name="decoder")
    x = BernoulliVariable(logits=decoder(z), name="x", log_prob_scale=float(n) / float(b))
    x.observe(xb)
    p_model = ProbabilisticModel([x])

    # q(z|x): amortized — the encoder reads the SAME minibatch variable
    enc_mu = BF.BrancherFunction(mu_net, name="enc_mu")
    enc_logsig = BF.BrancherFunction(logsig_net, name="enc_logsig")
    qz = NormalVariable(
        enc_mu(xb), BF.exp(BF.clip(enc_logsig(xb), -5.0, 3.0)), "z",
        log_prob_scale=float(n) / float(b),
    )
    q_model = ProbabilisticModel([qz])
    p_model.set_posterior_model(q_model)
    return p_model, q_model
