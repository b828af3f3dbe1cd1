"""Port parity: the bootstrap and streaming particle filters
(brancher_torch vs brancher_tpu).

Deterministic pieces are held exactly or to float tolerance: the
resampling indices on the same uniforms or Gumbel noise, the Kalman
filter, and a whole particle filter with JAX's key schedule replayed
(smc.py:91-132: the initial normals, then per step the resampling uniform
and the proposal normals), whose log-marginal, filter means and ESS agree
within 1e-4.  Whole runs are held to the exact Kalman answer with the JAX
tests' limits (tests/test_smc.py:28-38 and 144-167)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_torch.inference.smc as TSMC
import brancher_tpu.inference.smc as JSMC
from brancher_torch.inference.streaming_smc import streaming_particle_filter
from brancher_torch.models import kalman_filter as t_kalman
from brancher_torch.models import lgssm_state_space as t_lgssm_ssm
from brancher_tpu.models.state_space import LGSSMParams, kalman_filter, lgssm_state_space
from brancher_tpu.models.state_space import make_lgssm_data

torch.set_num_threads(2)


class Replay:
    """A draw source that hands out recorded numbers in order (the methods
    of ``smc.SMCRandom``); the shapes must match what the port asks for."""

    generator = None

    def __init__(self, arrays=()):
        self.queue = [np.array(a, np.float32) for a in arrays]
        self.i = 0

    def push(self, a):
        self.queue.append(np.array(a, np.float32))

    def _next(self, shape):
        a = self.queue[self.i]
        self.i += 1
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.as_tensor(a)

    uniform = normal = gumbel = _next

    def done(self):
        return self.i == len(self.queue)


def replay_lgssm(params, replay):
    """The LGSSM with its normals taken from ``replay`` (its callbacks
    ignore the generator)."""
    a, q, c, r, v0 = params
    base = t_lgssm_ssm(params)
    return TSMC.StateSpace(
        init_sample=lambda g, shape: math.sqrt(v0) * replay.normal(shape),
        init_log_prob=base.init_log_prob,
        trans_sample=lambda g, x, t: a * x + math.sqrt(q) * replay.normal(x.shape),
        trans_log_prob=base.trans_log_prob,
        obs_log_prob=base.obs_log_prob,
    )


def jax_filter_numbers(key, p, t_len, replay):
    """Push JAX particle_filter's numbers for ``key`` in the port's order."""
    k_init, k_scan = jax.random.split(key)
    normal = jax.vmap(lambda k: jax.random.normal(k, ()))
    replay.push(normal(jax.random.split(k_init, p)))
    for k in jax.random.split(k_scan, t_len - 1):
        k_res, k_prop = jax.random.split(k)
        replay.push(jax.random.uniform(k_res, ()))
        replay.push(normal(jax.random.split(k_prop, p)))


@pytest.mark.parametrize("p", [4, 64, 1000])
def test_systematic_indices_equal_jax(p):
    rng = np.random.RandomState(p)
    lw = (np.log([0.1, 0.2, 0.3, 0.4]) if p == 4 else 2 * rng.normal(size=p)).astype(np.float32)
    for i in range(20):
        key = jax.random.PRNGKey(i)
        want = JSMC.systematic_resample_indices(key, jnp.asarray(lw))
        got = TSMC.systematic_resample_indices(
            None, torch.as_tensor(lw), uniform=torch.as_tensor(np.array(jax.random.uniform(key, ()))))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [4, 64])
def test_multinomial_indices_equal_jax(p):
    lw = (2 * np.random.RandomState(p).normal(size=p)).astype(np.float32)
    for i in range(20):
        key = jax.random.PRNGKey(i)
        want = JSMC.multinomial_resample_indices(key, jnp.asarray(lw))
        g = torch.as_tensor(np.array(jax.random.gumbel(key, (p, p))))
        got = TSMC.multinomial_resample_indices(None, torch.as_tensor(lw), gumbel=g)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_indices_are_per_row():
    """With a leading axis every row resamples on its own uniform."""
    lw = torch.as_tensor(np.random.RandomState(0).normal(size=(3, 50)).astype(np.float32))
    u = torch.tensor([0.1, 0.5, 0.9])
    got = TSMC.systematic_resample_indices(None, lw, uniform=u)
    for i in range(3):
        assert torch.equal(got[i], TSMC.systematic_resample_indices(None, lw[i], uniform=u[i]))


def test_systematic_resampling_unbiased():
    lw = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(4)
    for _ in range(200):
        counts += np.bincount(TSMC.systematic_resample_indices(gen, lw).numpy(), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.3, 0.4], atol=0.02)


def test_kalman_filter_equals_jax():
    params = LGSSMParams(a=0.8, q=0.2, c=1.3, r=0.4, init_var=2.0)
    _, ys = make_lgssm_data(length=50, params=params, seed=4)
    for got, want in zip(t_kalman(ys, params), kalman_filter(ys, params)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_state_space_log_probs_match_jax():
    params = LGSSMParams()
    jssm, tssm = lgssm_state_space(params), t_lgssm_ssm(params)
    x = np.random.RandomState(0).normal(size=7).astype(np.float32)
    xp = np.random.RandomState(1).normal(size=7).astype(np.float32)
    for jf, tf, args in ((jssm.init_log_prob, tssm.init_log_prob, (x,)),
                         (jssm.trans_log_prob, tssm.trans_log_prob, (x, xp, 3)),
                         (jssm.obs_log_prob, tssm.obs_log_prob, (0.4, x, 3))):
        want = jax.vmap(lambda *a: jf(*a), in_axes=tuple(0 if isinstance(v, np.ndarray) else None
                                                         for v in args))(*args)
        got = tf(*[torch.as_tensor(v) if isinstance(v, np.ndarray) else v for v in args])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("resampling", ["systematic", "multinomial"])
def test_particle_filter_replays_jax(resampling):
    params = LGSSMParams()
    _, ys = make_lgssm_data(length=25, params=params, seed=1)
    p, key = 256, jax.random.PRNGKey(3)
    if resampling == "systematic":
        want = JSMC.particle_filter(lgssm_state_space(params), jnp.asarray(ys), p, key)
        replay = Replay()
        jax_filter_numbers(key, p, len(ys), replay)
    else:  # the same schedule with the Gumbel noise of each step's categorical draw
        want = JSMC.particle_filter(lgssm_state_space(params), jnp.asarray(ys), p, key,
                                    resampling="multinomial")
        replay = Replay()
        k_init, k_scan = jax.random.split(key)
        normal = jax.vmap(lambda k: jax.random.normal(k, ()))
        replay.push(normal(jax.random.split(k_init, p)))
        for k in jax.random.split(k_scan, len(ys) - 1):
            k_res, k_prop = jax.random.split(k)
            replay.push(jax.random.gumbel(k_res, (p, p)))
            replay.push(normal(jax.random.split(k_prop, p)))
    got = TSMC.particle_filter(replay_lgssm(params, replay), ys, p, resampling=resampling,
                               device="cpu", rng=replay)
    assert replay.done()
    assert float(jnp.min(want.ess_history)) < 0.5 * p  # resampling fired
    np.testing.assert_allclose(float(got.log_marginal), float(want.log_marginal), atol=1e-4)
    np.testing.assert_allclose(got.filter_means.numpy(), np.asarray(want.filter_means), atol=1e-4)
    np.testing.assert_allclose(got.ess_history.numpy(), np.asarray(want.ess_history),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.particles.numpy(), np.asarray(want.particles), atol=1e-4)


def test_particle_filter_matches_kalman():
    params = LGSSMParams()
    _, ys = make_lgssm_data(length=60, params=params, seed=1)
    ll_exact, means_exact, _ = t_kalman(ys, params)
    res = TSMC.smc_sample(t_lgssm_ssm(params), ys, num_particles=4096, key=0, device="cpu")
    assert abs(float(res.log_marginal) - ll_exact) < 0.5, (float(res.log_marginal), ll_exact)
    assert float(np.max(np.abs(res.filter_means.numpy() - means_exact))) < 0.08
    assert float(res.ess_history.min()) > 100


def test_batched_filter_runs_independent_systems():
    """batch_shape=(C,): C filters of one call, each a valid estimate, and
    different from the others (their own draws)."""
    params = LGSSMParams()
    _, ys = make_lgssm_data(length=40, params=params, seed=2)
    ll_exact, means_exact, _ = t_kalman(ys, params)
    res = TSMC.particle_filter(t_lgssm_ssm(params), ys, 2048, key=1, batch_shape=(3,),
                               device="cpu")
    assert tuple(res.log_marginal.shape) == (3,) and tuple(res.filter_means.shape) == (3, 40)
    assert tuple(res.particles.shape) == (3, 2048) and tuple(res.ess_history.shape) == (3, 40)
    assert float(torch.max(torch.abs(res.log_marginal - ll_exact))) < 0.7
    assert float(np.max(np.abs(res.filter_means.numpy() - means_exact))) < 0.1
    assert len(set(res.log_marginal.tolist())) == 3


def test_streaming_filter_matches_batch_and_kalman():
    """T=300, 2048 particles, lag 16, chunks of 64 (tests/test_smc.py:144-167):
    filter means within 0.15 of Kalman and log-marginal within 2.0 (the
    JAX test's limits), the same limits against the batch filter, and lag
    smoothing strictly better than filtering against the true path."""
    params = LGSSMParams()
    xs_true, ys = make_lgssm_data(length=300, params=params, seed=0)
    ssm = t_lgssm_ssm(params)
    kf_logml, kf_means, _ = t_kalman(ys, params)
    res = streaming_particle_filter(ssm, ys, num_particles=2048, key=0, lag=16,
                                    chunk_size=64, device="cpu")
    batch = TSMC.smc_sample(ssm, ys, num_particles=2048, key=1, device="cpu")
    fm = res.filter_means.ravel()
    assert np.abs(fm - kf_means).max() < 0.15
    assert abs(float(res.log_marginal) - kf_logml) < 2.0
    assert np.abs(fm - batch.filter_means.numpy()).max() < 0.15
    assert abs(float(res.log_marginal) - float(batch.log_marginal)) < 2.0
    sm = res.smoothed_means.ravel()
    assert np.isfinite(sm).all()
    rmse_f = float(np.sqrt(((fm - xs_true) ** 2).mean()))
    rmse_s = float(np.sqrt(((sm - xs_true) ** 2).mean()))
    assert rmse_s < rmse_f


def test_streaming_state_stays_constant_size():
    from brancher_torch.inference.streaming_smc import StreamingSMC

    params = LGSSMParams()
    _, ys = make_lgssm_data(length=130, params=params, seed=1)
    f = StreamingSMC(t_lgssm_ssm(params), num_particles=64, lag=8, chunk_size=50, device="cpu")
    state, _ = f.init(ys[0], key=0)
    pos, means = 1, []
    while pos < len(ys):
        state, (m, _sm, smt, _e) = f.process(state, ys[pos:pos + 30])
        assert tuple(state.lag_buf.shape) == (8, 64) and tuple(state.x.shape) == (64,)
        means.append(m)
        pos += m.shape[0]
    assert state.t == 130 and torch.cat(means).shape == (129,)
    tail, times = f.finalize(state)
    np.testing.assert_array_equal(times, np.arange(122, 130))


def test_sharded_arguments_and_default_device_raise():
    """The sharded modes are ported (tests/test_torch_sharded_smc.py): a
    mesh that is not a DeviceMesh raises a TypeError naming it, an unknown
    PMMH shard mode a ValueError, and exchange= without a mesh is ignored
    as in JAX (smc.py:413-421): the single-device filter, bit for bit."""
    from brancher_torch.inference import pmmh_sample, streaming_particle_filter as spf

    ssm = t_lgssm_ssm(LGSSMParams())
    ys = np.zeros(5, np.float32)
    for call in (lambda: TSMC.smc_sample(ssm, ys, 8, mesh=object(), device="cpu"),
                 lambda: spf(ssm, ys, 8, mesh=object(), device="cpu"),
                 lambda: pmmh_sample(None, ys, None, [0.0], mesh=object(), shard="both",
                                     device="cpu")):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
    with pytest.raises(ValueError, match="unknown shard mode"):
        pmmh_sample(None, ys, None, [0.0], mesh=object(), shard="rows", device="cpu")
    island = TSMC.smc_sample(ssm, ys, 8, key=4, exchange="island", device="cpu")
    plain = TSMC.smc_sample(ssm, ys, 8, key=4, device="cpu")
    assert torch.equal(island.filter_means, plain.filter_means)
    assert torch.equal(island.log_marginal, plain.log_marginal)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSMC.smc_sample(ssm, ys, 8)
