"""Port parity: particle-marginal Metropolis-Hastings (brancher_torch vs
brancher_tpu).

One iteration (the initial filters, the proposal, the filters at the
proposal, the accept and the Robbins-Monro step of the proposal scale) is
replayed against JAX's with its numbers (pmmh.py:108-138: ll0 from
fold_in(k_run, total + 1), per iteration fold_in(k_run, t) split into
proposal, filter and accept keys) and held at 1e-4.  The slow test holds
the posterior of the transition coefficient to the exact Kalman grid with
the JAX test's limits (tests/test_pmmh.py:27-74)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brancher_torch.inference import pmmh_sample
from brancher_torch.inference.smc import StateSpace
from brancher_torch.models import LGSSMParams
from brancher_tpu.inference.pmmh import pmmh_sample as j_pmmh_sample
from brancher_tpu.models.state_space import make_lgssm_data
from tests.test_pmmh import _kalman_loglik_grid, _make_ssm as j_make_ssm
from tests.test_torch_smc import Replay

torch.set_num_threads(2)


def make_ssm(theta, replay=None):
    """tests/test_pmmh.py's LGSSM with a = tanh(theta[0]), batched over the
    chains of theta [C, D]; with ``replay`` its normals are replayed."""
    a = torch.tanh(theta[:, 0])[:, None]
    p = LGSSMParams()

    def randn(g, shape):
        return replay.normal(shape) if replay is not None else torch.randn(
            tuple(shape), generator=g, device=g.device)

    return StateSpace(
        init_sample=lambda g, shape: math.sqrt(p.init_var) * randn(g, shape),
        init_log_prob=lambda x: -0.5 * x * x / p.init_var,
        trans_sample=lambda g, xp, t: a * xp + math.sqrt(p.q) * randn(g, xp.shape),
        trans_log_prob=lambda x, xp, t: -0.5 * (x - a * xp) ** 2 / p.q,
        obs_log_prob=lambda y, x, t: -0.5 * (y - p.c * x) ** 2 / p.r
        - 0.5 * math.log(2 * math.pi * p.r),
    )


def log_prior(th):
    return -0.5 * torch.sum((th / 1.5) ** 2, dim=-1)


def j_log_prior(th):
    return -0.5 * jnp.sum((th / 1.5) ** 2)


def push_filters(chain_keys, p, t_len, replay):
    """Push the numbers of C per-chain JAX filters in the port's batched
    order: the initial normals [C, P], then per step the uniforms [C] and
    the proposal normals [C, P]."""
    normal = jax.vmap(lambda k: jax.random.normal(k, ()))
    splits = [jax.random.split(k) for k in chain_keys]
    replay.push(np.stack([normal(jax.random.split(ki, p)) for ki, _ in splits]))
    steps = [jax.random.split(ks, t_len - 1) for _, ks in splits]
    for i in range(t_len - 1):
        parts = [jax.random.split(s[i]) for s in steps]
        replay.push(np.stack([jax.random.uniform(kr, ()) for kr, _ in parts]))
        replay.push(np.stack([normal(jax.random.split(kp, p)) for _, kp in parts]))


@pytest.mark.parametrize("warm", [False, True], ids=["draw", "warmup"])
def test_one_pmmh_iteration_replays_jax(warm):
    _, ys = make_lgssm_data(length=20, params=LGSSMParams(a=0.85), seed=0)
    c, p, key = 4, 32, jax.random.PRNGKey(5)
    theta0 = np.arctanh(np.asarray([[0.6], [0.7], [0.8], [0.9]], np.float32))
    kw = dict(num_samples=0 if warm else 1, num_warmup=1 if warm else 0, num_particles=p,
              num_chains=c)
    want = j_pmmh_sample(j_make_ssm, jnp.asarray(ys), j_log_prior, jnp.asarray(theta0), key=key, **kw)
    replay = Replay()
    _, k_run = jax.random.split(key)
    push_filters(jax.random.split(jax.random.fold_in(k_run, 2), c), p, len(ys), replay)
    k_prop, k_pf, k_acc = jax.random.split(jax.random.fold_in(k_run, 0), 3)
    replay.push(jax.random.normal(k_prop, (c, 1)))
    push_filters(jax.random.split(k_pf, c), p, len(ys), replay)
    replay.push(jax.random.uniform(k_acc, (c,)))
    got = pmmh_sample(lambda th: make_ssm(th, replay), ys, log_prior, theta0, device="cpu",
                      rng=replay, **kw)
    assert replay.done()
    np.testing.assert_allclose(got.proposal_scale.numpy(), np.asarray(want.proposal_scale),
                               rtol=1e-5)
    if warm:
        assert float(got.proposal_scale[0]) != 0.1  # the scale moved
        return
    np.testing.assert_allclose(got.thetas.numpy(), np.asarray(want.thetas), atol=1e-6)
    np.testing.assert_allclose(got.log_marginals.numpy(), np.asarray(want.log_marginals),
                               atol=1e-4)
    assert float(got.accept_rate) == float(want.accept_rate)
    assert 0.0 < float(got.accept_rate) < 1.0  # some chains moved, some stayed


def test_pmmh_result_shapes_and_jitter():
    _, ys = make_lgssm_data(length=15, params=LGSSMParams(a=0.85), seed=0)
    res = pmmh_sample(make_ssm, ys, log_prior, [np.arctanh(0.7)], num_samples=6, num_warmup=4,
                      num_particles=16, num_chains=3, key=0, device="cpu")
    assert tuple(res.thetas.shape) == (3, 6, 1) and tuple(res.log_marginals.shape) == (3, 6)
    assert len(set(res.thetas[:, 0, 0].tolist())) == 3  # chains start jittered apart
    assert bool(torch.isfinite(res.log_marginals).all())


@pytest.mark.slow
def test_pmmh_recovers_transition_coefficient():
    params = LGSSMParams(a=0.85)
    _, ys = make_lgssm_data(length=60, params=params, seed=0)
    mean_a, sd_a = _kalman_loglik_grid(ys)
    res = pmmh_sample(make_ssm, ys, log_prior, [np.arctanh(0.7)], num_samples=400,
                      num_warmup=200, num_particles=128, num_chains=8, key=0, device="cpu")
    a_draws = np.tanh(res.thetas[..., 0].numpy().ravel())
    assert 0.05 < float(res.accept_rate) < 0.8, float(res.accept_rate)
    assert abs(a_draws.mean() - mean_a) < 2.5 * sd_a, (a_draws.mean(), mean_a, sd_a)
    assert 0.3 * sd_a < a_draws.std() < 3.5 * sd_a, (a_draws.std(), sd_a)
