"""Port parity: the draw-pipelined sampling phase, ``NUTS(pipelined=True)``.

With JAX's per-iteration numbers fed in (``fold_in(key, it)`` split in
four: momenta, directions, swaps, takes), the port's
``_pipelined_sampling`` must give JAX's draws, accept probabilities,
divergences, iteration count and live leapfrogs a draw, stalls included
(``lookahead=2``: chains wait for the slowest).  The port writes each
draw straight into the output where JAX goes through a ring; the stall
rule is kept.  Whole runs mirror the JAX tests
(``tests/test_vectorized_nuts.py:233-310``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu.inference.vectorized_nuts as JV
import brancher_tpu.ops.pallas_glm as PG
import brancher_torch.inference.vectorized_nuts as TV
import brancher_torch.ops.glm as G
from brancher_torch import LogNormalVariable, NormalVariable, ProbabilisticModel
from brancher_torch.inference import NUTS, sample

torch.set_num_threads(2)


class PipelineStream:
    """brancher_tpu's _pipelined_sampling numbers: per iteration `it`,
    split(fold_in(key, it), 4) into momentum, direction, swap and take."""

    def __init__(self, key, c, d):
        def draw(it):
            k_mom, k_dir, k_swap, k_take = jax.random.split(jax.random.fold_in(key, it), 4)
            return (jax.random.normal(k_mom, (c, d), jnp.float32),
                    jax.random.bernoulli(k_dir, 0.5, (c,)),
                    jax.random.uniform(k_swap, (c,)), jax.random.uniform(k_take, (c,)))

        self.draw = jax.jit(draw)
        self.iterations = 0

    def iteration(self, it, z):
        assert it == self.iterations  # iterations come in order, once each
        self.iterations += 1
        return tuple(torch.as_tensor(np.array(a)) for a in self.draw(it))


def _target(seed, n=50, d=2):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    b = np.zeros(n, np.float32)
    m = np.zeros(d, np.float32)
    iv = np.full(d, 0.5, np.float32)
    jvg = lambda z: PG.bernoulli_vg_reference(z, *map(jnp.asarray, (x, y, b, m, iv)))
    tvg = lambda z: G.bernoulli_vg_reference(z, *map(torch.as_tensor, (x, y, b, m, iv)))
    return jvg, tvg, d


@pytest.mark.parametrize("seed,eps,lookahead,max_delta", [
    (0, 0.3, 2, 1000.0),   # constant backpressure: chains stall
    (1, 0.1, 16, 1000.0),  # deeper trees, no stall
    (2, 1.4, 2, 3.0),      # divergences end trees early
])
def test_pipelined_sampling_replays_jax(seed, eps, lookahead, max_delta):
    jvg, tvg, d = _target(seed)
    c, draws, max_depth = 4, 6, 5
    z = np.random.RandomState(20 + seed).normal(0, 0.5, size=(c, d)).astype(np.float32)
    inv_mass = np.linspace(0.8, 1.2, d).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jval, jgrad = jvg(jnp.asarray(z))
    jzs, jacc, jdvg, jiters, jcnt = JV._pipelined_sampling(
        jvg, jnp.asarray(z), jval, jgrad, jnp.float32(eps), jnp.asarray(inv_mass), key, draws,
        max_depth, max_delta, lookahead=lookahead)

    stream = PipelineStream(key, c, d)
    tval, tgrad = tvg(torch.as_tensor(z))
    zs, acc, dvg, iters, cnt, syncs = TV._pipelined_sampling(
        tvg, torch.as_tensor(z), tval, tgrad, torch.tensor(eps), torch.as_tensor(inv_mass), stream,
        draws, max_depth, max_delta, lookahead=lookahead)

    assert iters == int(jiters) == stream.iterations
    assert syncs == iters + 1  # one host sync an iteration, and the last check
    np.testing.assert_allclose(zs.numpy(), np.asarray(jzs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(dvg.numpy(), np.asarray(jdvg))
    np.testing.assert_allclose(cnt.numpy(), np.asarray(jcnt), rtol=1e-6)
    if max_delta < 10:
        assert bool(dvg.any())


def test_nuts_batched_reports_amortised_iterations():
    """num_leapfrog: the iterations a draw, rounded up, as JAX reports them;
    warmup stays lockstep."""
    _, tvg, d = _target(3)
    z0 = torch.zeros((5, d))
    res = TV.nuts_batched(tvg, z0, 30, 25, torch.Generator().manual_seed(0), max_depth=5,
                          pipeline=True, lookahead=4)
    iters = int(res.num_leapfrog[0])
    assert torch.equal(res.num_leapfrog, torch.full((25,), iters))
    assert res.samples.shape == (5, 25, d) and bool((res.samples != 0).all())
    assert res.chain_leapfrog.shape == (25,)
    # a draw takes at least its chains' mean live leapfrogs
    assert iters >= float(res.chain_leapfrog.mean())
    assert res.warmup_leapfrog > 0 and res.host_syncs > res.warmup_leapfrog


def _conjugate(seed):
    obs = np.random.RandomState(seed).randn(16).astype(np.float32) + 1.5
    mu = NormalVariable(0.0, 2.0, "mu")
    x = NormalVariable(mu, 1.0, "x", plate_shape=(16,))
    x.observe(obs)
    v_post = 1.0 / (0.25 + 16)
    return ProbabilisticModel([x]), v_post * obs.sum(), v_post


@pytest.mark.slow  # about 10 s on a CPU
def test_pipelined_nuts_conjugate_moments():
    """Mirrors tests/test_vectorized_nuts.py:233."""
    m, m_post, v_post = _conjugate(0)
    res = sample(m, kernel=NUTS(max_depth=8, pipelined=True), num_samples=1500, num_warmup=500,
                 num_chains=8, key=0, device="cpu")
    s = res.samples["mu"].numpy()
    se = np.sqrt(v_post / max(float(res.diagnostics["ess"]["mu"]), 1))
    assert abs(s.mean() - m_post) < 5 * se + 0.02, (s.mean(), m_post)
    assert abs(s.var() - v_post) < 0.25 * v_post, (s.var(), v_post)
    assert float(res.diagnostics["r_hat"]["mu"]) < 1.02
    assert int(res.diagnostics["num_divergences"]) == 0
    assert res.samples["mu"].shape == (8, 1500)


def test_pipelined_nuts_conjugate_short_run():
    """The same model and limits at a tenth of the draws."""
    m, m_post, v_post = _conjugate(0)
    res = sample(m, kernel=NUTS(max_depth=8, pipelined=True), num_samples=200, num_warmup=200,
                 num_chains=8, key=1, device="cpu")
    s = res.samples["mu"].numpy()
    se = np.sqrt(v_post / max(float(res.diagnostics["ess"]["mu"]), 1))
    assert abs(s.mean() - m_post) < 5 * se + 0.02, (s.mean(), m_post)
    assert abs(s.var() - v_post) < 0.25 * v_post, (s.var(), v_post)
    d = res.diagnostics
    assert d["chain_leapfrog"].shape == (200,)
    assert d["total_leapfrog_steps"] == int(res.stats["num_steps"].sum())
    assert 0 < d["sampling_seconds"] < d["sampler_seconds"]  # the draws' loop alone


@pytest.mark.slow  # about 2.5 min on a CPU
def test_pipelined_matches_lockstep_on_funnel():
    """Eight-schools geometry (mirrors tests/test_vectorized_nuts.py:254,
    with tau ~ LogNormal(1, 1) for HalfCauchy(5), which the port does not
    have yet, and 8 chains, 300 + 300 draws, max_depth 7 for JAX's 16,
    500 + 800 and 9, for CPU time): the two engines agree on the posterior
    means, and the pipelined one runs fewer iterations."""
    mu = NormalVariable(0.0, 5.0, "mu")
    tau = LogNormalVariable(1.0, 1.0, "tau")
    theta = NormalVariable(mu, tau, "theta", plate_shape=(8,))
    sigma = np.asarray([15., 10., 16., 11., 9., 11., 10., 18.], np.float32)
    obs = NormalVariable(theta, sigma, "y")
    obs.observe(np.asarray([28., 8., -3., 7., -1., 1., 18., 12.], np.float32))
    m = ProbabilisticModel([obs])
    kw = dict(num_samples=300, num_warmup=300, num_chains=8, key=0, device="cpu")
    r_lock = sample(m, kernel=NUTS(max_depth=7), **kw)
    r_pipe = sample(m, kernel=NUTS(max_depth=7, pipelined=True), **kw)
    for name in ("mu", "tau"):
        a = float(r_lock.samples[name].mean())
        b = float(r_pipe.samples[name].mean())
        assert abs(a - b) < 0.75, (name, a, b)
    it_lock = int(r_lock.stats["num_steps"][0].sum())
    it_pipe = int(r_pipe.stats["num_steps"][0].sum())
    assert it_pipe < it_lock, (it_pipe, it_lock)


def test_pipelined_tiny_lookahead():
    """lookahead=2 keeps chains stalling; every output row must be a real
    draw (mirrors tests/test_vectorized_nuts.py:281)."""
    m, m_post, v_post = _conjugate(1)
    res = sample(m, kernel=NUTS(max_depth=8, pipelined=True, lookahead=2), num_samples=1000,
                 num_warmup=500, num_chains=8, key=0, device="cpu")
    s = res.samples["mu"].numpy()
    assert s.shape == (8, 1000)
    assert np.all(np.abs(s) > 1e-12)
    dup_frac = np.mean(s[:, 1:] == s[:, :-1])
    assert dup_frac < 0.2, dup_frac
    assert abs(s.mean() - m_post) < 0.05, (s.mean(), m_post)
    assert abs(s.var() - v_post) < 0.3 * v_post, (s.var(), v_post)
