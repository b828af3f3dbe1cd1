"""Port parity: the adaptive tempered SMC sampler (brancher_torch vs
brancher_tpu).

The next-beta bisection, the evidence increment and the ESS are held to
JAX's on fixed log-likelihood vectors (JAX's run of one or two stages
without rejuvenation), and whole stages with HMC rejuvenation to JAX's
with its resampling uniforms, momenta and accept uniforms replayed
(tempered_smc.py:75-127: per stage fold_in(key, stage) split into the
resampling and rejuvenation keys, per HMC step split(k, 3)), at 1e-5
(beta, an f32 bisection) and 1e-4 (particles after 8 leapfrog steps).
Whole runs are held to the conjugate closed form with the JAX tests'
limits (tests/test_tempered_smc.py:13-27)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from brancher_torch.models import conjugate_normal_model as t_conj
from tests.test_torch_smc import Replay

# the packages export the function tempered_smc under the module's name
TT = importlib.import_module("brancher_torch.inference.tempered_smc")
JT = importlib.import_module("brancher_tpu.inference.tempered_smc")

torch.set_num_threads(2)
DATA = np.random.RandomState(0).normal(1.5, 1.0, size=20).astype(np.float32)


def _stage_numbers(key, stage, p, d, steps, replay):
    """Push JAX's numbers of one stage: the resampling uniform, then per
    HMC step the momenta and the accept uniforms."""
    k_res, k = jax.random.split(jax.random.fold_in(key, stage))
    replay.push(jax.random.uniform(k_res, ()))
    for _ in range(steps):
        k, k_mom, k_acc = jax.random.split(k, 3)
        replay.push(jax.random.normal(k_mom, (p, d)))
        replay.push(jax.random.uniform(k_acc, (p,)))


@pytest.mark.parametrize("scale", [0.05, 1.0, 30.0])
def test_next_beta_and_evidence_match_jax(scale):
    """Two stages without rejuvenation on log_lik(z) = z[:, 0] (z0 holding
    a fixed vector): betas, ESS and log-evidence as JAX's; the scale takes
    beta to 1 at once (0.05) or through bisection (1, 30)."""
    p = 512
    lik = (scale * np.random.RandomState(1).normal(size=p)).astype(np.float32)
    z0 = np.stack([lik, np.zeros(p, np.float32)], axis=1)
    key = jax.random.PRNGKey(2)
    want = JT.tempered_smc(lambda z: jnp.zeros(z.shape[0]), lambda z: z[:, 0], jnp.asarray(z0),
                           key, rejuvenation_steps=0, max_stages=2)
    replay = Replay()
    for stage in range(int(want.num_stages)):
        _stage_numbers(key, stage, p, 2, 0, replay)
    got = TT.tempered_smc(lambda z: torch.zeros(z.shape[0]), lambda z: z[:, 0],
                          torch.as_tensor(z0), rejuvenation_steps=0, max_stages=2, rng=replay)
    assert replay.done() and got.num_stages == int(want.num_stages)
    np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.ess_history.numpy(), np.asarray(want.ess_history), rtol=1e-4)
    np.testing.assert_allclose(float(got.log_evidence), float(want.log_evidence), atol=1e-4)
    np.testing.assert_allclose(got.particles.numpy(), np.asarray(want.particles), atol=0)
    if scale == 0.05:
        assert got.num_stages == 1 and float(got.betas[1]) == 1.0


def test_next_beta_from_a_positive_beta():
    lik = (3.0 * np.random.RandomState(2).normal(size=256)).astype(np.float32)
    beta = TT.next_beta(torch.tensor(0.2), torch.as_tensor(lik))
    ess = TT._ess((beta - 0.2) * torch.as_tensor(lik))
    assert 0.2 < float(beta) < 1.0 and abs(float(ess) / 256 - 0.5) < 1e-3


def _conj_fns(lib):
    x = lib.as_tensor(DATA) if lib is torch else jnp.asarray(DATA)

    def log_prior(z):
        return -0.5 * z[:, 0] ** 2 / 4.0

    def log_lik(z):
        return lib.sum(-0.5 * (x[None, :] - z[:, :1]) ** 2, -1) if lib is torch else \
            jnp.sum(-0.5 * (x[None, :] - z[:, :1]) ** 2, -1)
    return log_prior, log_lik


def test_rejuvenation_steps_replay_jax():
    """One stage with two HMC rejuvenation steps on the conjugate target:
    the same resampling, momenta and accept uniforms give the same
    particles."""
    p, key = 256, jax.random.PRNGKey(4)
    z0 = (2.0 * np.random.RandomState(3).normal(size=(p, 1))).astype(np.float32)
    jp, jl = _conj_fns(jnp)
    want = JT.tempered_smc(jp, jl, jnp.asarray(z0), key, rejuvenation_steps=2, max_stages=1)
    replay = Replay()
    _stage_numbers(key, 0, p, 1, 2, replay)
    tp, tl = _conj_fns(torch)
    got = TT.tempered_smc(tp, tl, torch.as_tensor(z0), rejuvenation_steps=2, max_stages=1,
                          rng=replay)
    assert replay.done()
    np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas), atol=1e-5)
    moved = np.mean(~np.isin(np.asarray(want.particles), z0))
    assert moved > 0.5  # the HMC steps moved most particles
    np.testing.assert_allclose(got.particles.numpy(), np.asarray(want.particles), atol=1e-4)


def test_tempered_smc_conjugate():
    model, truth = t_conj(num_obs=20)
    samples, res = TT.smc_posterior_sample(model, num_particles=2048, key=0, device="cpu")
    mu = samples["mu"].numpy()
    assert abs(mu.mean() - truth["post_mean"]) < 0.05
    assert abs(mu.var() - truth["post_var"]) < 0.03
    assert res.num_stages >= 2
    n = len(truth["data"])
    logz = st.multivariate_normal(mean=np.zeros(n), cov=np.eye(n) + 4.0 * np.ones((n, n))
                                  ).logpdf(truth["data"])
    assert abs(float(res.log_evidence) - logz) < 0.3, (float(res.log_evidence), logz)


def test_tempered_smc_constrained_latent():
    import brancher_torch as BT

    s = BT.LogNormalVariable(0.0, 0.5, "s")
    x = BT.NormalVariable(0.0, s, "x")
    x.observe(np.random.RandomState(0).normal(0, 1.2, 60).astype(np.float32))
    samples, _ = TT.smc_posterior_sample(BT.ProbabilisticModel([x]), num_particles=1024, key=0,
                                         device="cpu")
    sv = samples["s"].numpy()
    assert np.all(sv > 0)
    assert 1.0 < sv.mean() < 1.45, sv.mean()
