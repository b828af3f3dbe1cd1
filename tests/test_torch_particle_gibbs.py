"""Port parity: particle Gibbs with ancestor sampling (brancher_torch vs
brancher_tpu).

One conditional-SMC sweep for three chains is replayed against JAX's
``_pgas_sweep`` with its numbers (particle_gibbs.py:60-108: split(key, 3)
into init, scan and pick keys, per step split(k, 3) into the resampling,
ancestor and proposal keys) and must give the same trajectories; the
complete-data log posterior is held to JAX's at rtol 1e-5.  The slow
tests hold the posterior of the transition coefficient to the exact
Kalman grid and the trajectories to the RTS smoother with the JAX tests'
limits (tests/test_particle_gibbs.py:36-87)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_torch.inference.particle_gibbs as TPG
import brancher_tpu.inference.particle_gibbs as JPG
from brancher_torch.models import LGSSMParams
from brancher_tpu.models.state_space import make_lgssm_data
from tests.test_particle_gibbs import _rts_smoother
from tests.test_pmmh import _kalman_loglik_grid, _make_ssm as j_make_ssm
from tests.test_torch_pmmh import j_log_prior, log_prior, make_ssm
from tests.test_torch_smc import Replay

torch.set_num_threads(2)
THETA = np.arctanh(np.asarray([[0.6], [0.85], [0.95]], np.float32))


@pytest.mark.parametrize("ancestor_sampling", [True, False], ids=["as", "plain"])
def test_one_pgas_sweep_replays_jax(ancestor_sampling):
    _, ys = make_lgssm_data(length=25, params=LGSSMParams(a=0.85), seed=1)
    c, p, t_len = 3, 16, 25
    refs = np.random.RandomState(2).normal(size=(c, t_len)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), c)
    want = np.stack([np.asarray(JPG._pgas_sweep(j_make_ssm(jnp.asarray(THETA[i])), jnp.asarray(ys),
                                                jnp.asarray(refs[i]), p, keys[i],
                                                ancestor_sampling)) for i in range(c)])
    normal = jax.vmap(lambda k: jax.random.normal(k, ()))
    parts = [jax.random.split(k, 3) for k in keys]
    replay = Replay()
    replay.push(np.stack([normal(jax.random.split(ki, p)) for ki, _, _ in parts]))
    steps = [jax.random.split(ks, t_len - 1) for _, ks, _ in parts]
    for i in range(t_len - 1):
        ks = [jax.random.split(s[i], 3) for s in steps]
        replay.push(np.stack([jax.random.gumbel(k[0], (p, p)) for k in ks]))
        if ancestor_sampling:
            replay.push(np.stack([jax.random.gumbel(k[1], (p,)) for k in ks]))
        replay.push(np.stack([normal(jax.random.split(k[2], p)) for k in ks]))
    replay.push(np.stack([jax.random.gumbel(kp, (p,)) for _, _, kp in parts]))
    got = TPG._pgas_sweep(make_ssm(torch.as_tensor(THETA), replay), torch.as_tensor(ys),
                          torch.as_tensor(refs), p, replay, ancestor_sampling)
    assert replay.done()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert float(np.abs(want - refs).max()) > 0.1  # a new path was drawn


def test_complete_data_log_post_matches_jax():
    _, ys = make_lgssm_data(length=30, params=LGSSMParams(a=0.85), seed=3)
    traj = np.random.RandomState(4).normal(size=(3, 30)).astype(np.float32)
    want = [float(JPG._complete_data_log_post(j_make_ssm, j_log_prior, jnp.asarray(THETA[i]),
                                              jnp.asarray(traj[i]), jnp.asarray(ys)))
            for i in range(3)]
    got = TPG._complete_data_log_post(make_ssm, log_prior, torch.as_tensor(THETA),
                                      torch.as_tensor(traj), torch.as_tensor(ys))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_particle_gibbs_result_shapes():
    _, ys = make_lgssm_data(length=12, params=LGSSMParams(a=0.85), seed=0)
    res = TPG.particle_gibbs_sample(make_ssm, ys, log_prior, [np.arctanh(0.7)], num_samples=5,
                                    num_warmup=3, num_particles=8, num_chains=2, key=0,
                                    device="cpu")
    assert tuple(res.thetas.shape) == (2, 5, 1) and tuple(res.trajectories.shape) == (2, 5, 12)
    assert 0.0 <= float(res.accept_rate) <= 1.0
    assert bool(torch.isfinite(res.trajectories).all())


@pytest.mark.slow
def test_pgas_recovers_transition_coefficient():
    params = LGSSMParams(a=0.85)
    _, ys = make_lgssm_data(length=60, params=params, seed=0)
    mean_a, sd_a = _kalman_loglik_grid(ys)
    res = TPG.particle_gibbs_sample(make_ssm, ys, log_prior, [np.arctanh(0.7)], num_samples=400,
                                    num_warmup=200, num_particles=32, num_chains=8, key=0,
                                    device="cpu")
    a_draws = np.tanh(res.thetas[..., 0].numpy().ravel())
    assert 0.05 < float(res.accept_rate) < 0.9, float(res.accept_rate)
    assert abs(a_draws.mean() - mean_a) < 2.5 * sd_a, (a_draws.mean(), mean_a, sd_a)
    assert 0.3 * sd_a < a_draws.std() < 3.5 * sd_a, (a_draws.std(), sd_a)


@pytest.mark.slow
def test_pgas_trajectories_match_rts_smoother():
    params = LGSSMParams(a=0.85)
    _, ys = make_lgssm_data(length=50, params=params, seed=1)
    s_means, s_vars = _rts_smoother(ys, params)
    theta_true = float(np.arctanh(0.85))
    res = TPG.particle_gibbs_sample(
        lambda th: make_ssm(torch.full_like(th, theta_true)), ys, log_prior, [theta_true],
        num_samples=300, num_warmup=100, num_particles=32, num_chains=8, key=0, device="cpu")
    trajs = res.trajectories.numpy().reshape(-1, 50)
    se = np.sqrt(s_vars) * 3.0 / np.sqrt(50.0) + 0.08
    err = np.abs(trajs.mean(0) - s_means)
    assert np.all(err < np.maximum(3.0 * se, 0.15)), float(err.max())
    assert 0.5 < float(np.median(trajs.var(0) / s_vars)) < 2.0
