"""Port parity: the per-chain engines of ``chain_method="vmap"``.

JAX writes NUTS's and HMC's steps for one chain and ``vmap``s them; the
port's steps take a [C, d] block and mask the chains that have stopped.
With each chain's JAX numbers fed in (per chain key: ``split(key)`` into
momentum and loop keys for NUTS, ``split(key, 3)`` for HMC), one port
step must give the vmapped JAX step's result to float tolerance.  The
Welford estimator and the per-chain step-size probe are held alike.
Whole runs are held to the vectorized engine and to themselves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu.inference.adaptation as JA
import brancher_tpu.inference.hmc as JH
import brancher_tpu.inference.nuts as JN
import brancher_torch.inference.adaptation as TA
import brancher_torch.inference.hmc as TH
import brancher_torch.inference.nuts as TN
from brancher_torch.inference import HMC, NUTS, ChEESHMC, sample
from brancher_torch.models import conjugate_normal_model, logistic_regression_model, make_logreg_data

torch.set_num_threads(2)


def _potentials(seed, n=40, d=3):
    """A logistic-regression potential energy of one z [d], in both."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.as_tensor(x), torch.as_tensor(y)

    def jpot(z):
        logits = jx @ z
        return -jnp.sum(jy * logits - jnp.logaddexp(logits, 0.0)) + 0.25 * jnp.sum(z * z)

    def tpot(z):
        logits = tx @ z
        return -torch.sum(ty * logits - torch.logaddexp(logits, torch.zeros(()))) + 0.25 * torch.sum(z * z)

    return jpot, tpot, d


def _t(a):
    return torch.as_tensor(np.array(a))


class NutsNumbers:
    """Each chain's numbers in brancher_tpu's per-chain NUTS step for its
    key: the momentum from k_mom; per doubling split(t.key, 4) into
    direction, subtree, merge and next keys; per leaf split(subtree key)."""

    def __init__(self, keys, d, max_depth):
        def one(key):
            k_mom, t = jax.random.split(key)
            dirs, merges, swaps = [], [], []
            for dep in range(max_depth):
                k_dir, k_sub, k_merge, t = jax.random.split(t, 4)
                dirs.append(jax.random.bernoulli(k_dir, 0.5))
                merges.append(jax.random.uniform(k_merge, ()))
                row = []
                for _ in range(2**dep):
                    k1, k_sub = jax.random.split(k_sub)
                    row.append(jax.random.uniform(k1, ()))
                swaps.append(jnp.stack(row))
            return jax.random.normal(k_mom, (d,), jnp.float32), jnp.stack(dirs), jnp.stack(merges), swaps

        mom, dirs, merges, swaps = jax.vmap(one)(keys)
        self.mom, self.dirs, self.merges = _t(mom), _t(dirs), _t(merges)
        self.swaps = [_t(s) for s in swaps]
        self.leaves = 0

    def momentum(self, z):
        return self.mom

    def tree(self, depth, c, like):
        return self.dirs[:, depth], self.merges[:, depth]

    def leaf(self, depth, i, c, like):
        self.leaves += 1
        return self.swaps[depth][:, i]


class HmcNumbers:
    """Each chain's numbers in brancher_tpu's per-chain HMC step:
    split(key, 3) into momentum, accept and length keys."""

    def __init__(self, keys, d, length):
        def one(key):
            k_mom, k_acc, k_len = jax.random.split(key, 3)
            return (jax.random.normal(k_mom, (d,), jnp.float32), jax.random.uniform(k_acc, ()),
                    jax.random.randint(k_len, (), 1, length + 1))

        self.mom, self.acc, self.len = map(_t, jax.vmap(one)(keys))

    def momentum(self, z):
        return self.mom

    def accept(self, c, like):
        return self.acc

    def num_steps(self, high, c, device):
        return self.len


def _start(tpot, jpot, c, d, seed):
    z0 = np.random.RandomState(seed).normal(0, 0.5, size=(c, d)).astype(np.float32)
    jstate = jax.vmap(lambda z: JH.init_chain_state(jpot, z))(jnp.asarray(z0))
    tstate = TH.init_chain_state(TH.autodiff_value_and_grad(tpot), torch.as_tensor(z0))
    np.testing.assert_allclose(tstate.pe.numpy(), np.asarray(jstate.pe), rtol=1e-5)
    return jstate, tstate


def _check_state(got, want):
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.pe.numpy(), np.asarray(want.pe), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.grad.numpy(), np.asarray(want.grad), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed,eps,max_delta", [
    (0, 0.2, 1000.0),   # typical trees
    (1, 0.04, 1000.0),  # small steps: deep trees, chains stopping at different depths
    (2, 1.5, 3.0),      # large steps and a low threshold: divergences
])
def test_nuts_make_step_replays_jax(seed, eps, max_delta):
    jpot, tpot, d = _potentials(seed)
    c, max_depth = 7, 6
    jstate, tstate = _start(tpot, jpot, c, d, 10 + seed)
    inv_mass = np.linspace(0.6, 1.4, d).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), c)
    jstep = JN.NUTS(max_depth=max_depth, max_delta_energy=max_delta).make_step(jpot)
    jnew, jst = jax.vmap(jstep, in_axes=(0, 0, None, None))(
        keys, jstate, jnp.float32(eps), jnp.asarray(inv_mass))

    numbers = NutsNumbers(keys, d, max_depth)
    tstep = TN.NUTS(max_depth=max_depth, max_delta_energy=max_delta).make_step(tpot)
    tnew, tst = tstep(numbers, tstate, torch.tensor(eps), torch.as_tensor(inv_mass))

    _check_state(tnew, jnew)
    for k in ("diverging", "num_steps", "tree_depth"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    np.testing.assert_allclose(tst["accept_prob"].numpy(), np.asarray(jst["accept_prob"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tst["energy"].numpy(), np.asarray(jst["energy"]), rtol=1e-5, atol=1e-4)
    # the masked batch runs the leaves of the largest tree, at most
    assert int(jst["num_steps"].max()) <= numbers.leaves <= 2 ** int(jst["tree_depth"].max()) - 1
    assert tst["host_syncs"] >= int(jst["tree_depth"].max())
    if seed == 1:
        assert len(set(np.asarray(jst["tree_depth"]).tolist())) > 1
    if seed == 2:
        assert bool(np.asarray(jst["diverging"]).any())


@pytest.mark.parametrize("jitter", [True, False], ids=["jittered", "fixed"])
def test_hmc_make_step_replays_jax(jitter):
    jpot, tpot, d = _potentials(3)
    c, length = 9, 7
    jstate, tstate = _start(tpot, jpot, c, d, 4)
    inv_mass = np.linspace(0.8, 1.2, d).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), c)
    kernel = dict(num_integration_steps=length, jitter_steps=jitter)
    jnew, jst = jax.vmap(JH.HMC(**kernel).make_step(jpot), in_axes=(0, 0, None, None))(
        keys, jstate, jnp.float32(0.25), jnp.asarray(inv_mass))
    tnew, tst = HMC(**kernel).make_step(tpot)(
        HmcNumbers(keys, d, length), tstate, torch.tensor(0.25), torch.as_tensor(inv_mass))
    _check_state(tnew, jnew)
    for k in ("diverging", "num_steps"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    np.testing.assert_allclose(tst["accept_prob"].numpy(), np.asarray(jst["accept_prob"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tst["energy"].numpy(), np.asarray(jst["energy"]), rtol=1e-5, atol=1e-4)
    if jitter:  # chains integrate for their own counts
        assert len(set(tst["num_steps"].tolist())) > 1


def test_welford_matches_jax():
    x = np.random.RandomState(0).normal(2.0, 3.0, size=(5, 17, 4)).astype(np.float32)

    def jrun(xs):
        def body(s, xi):
            return JA.welford_update(s, xi), None

        s, _ = jax.lax.scan(body, JA.welford_init(4), xs)
        return s, JA.welford_variance(s), JA.welford_variance(s, regularize=False)

    jstate, jvar, jraw = jax.vmap(jrun)(jnp.asarray(x))
    state = TA.welford_init(4, batch=(5,))
    for t in range(x.shape[1]):
        state = TA.welford_update(state, torch.as_tensor(x[:, t]))
    for got, want in ((state.mean, jstate.mean), (state.m2, jstate.m2), (state.count, jstate.count),
                      (TA.welford_variance(state), jvar),
                      (TA.welford_variance(state, regularize=False), jraw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    one = TA.welford_update(TA.welford_init(4), torch.as_tensor(x[0, 0]))
    assert one.count.shape == () and one.mean.shape == (4,)


@pytest.mark.parametrize("scale,init_step", [(0.01, 1.0), (5.0, 1e-3), (1.0, 0.5)],
                         ids=["halving", "doubling", "near"])
def test_find_reasonable_step_size_matches_jax(scale, init_step):
    c, d = 16, 3
    sc = np.asarray([scale, 2 * scale, 0.5 * scale], np.float32)

    def jpot(z):
        return 0.5 * jnp.sum((z / sc) ** 2)

    def tvg(z):
        zz = z / torch.as_tensor(sc)
        return -0.5 * torch.sum(zz * zz, -1), -zz / torch.as_tensor(sc)

    z = (np.random.RandomState(1).normal(size=(c, d)) * sc).astype(np.float32)
    inv_mass = np.linspace(0.5, 1.5, d).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), c)
    want = jax.vmap(lambda zz, k: JA.find_reasonable_step_size(
        jpot, zz, jnp.asarray(inv_mass), k, init_step=init_step, target=0.8))(jnp.asarray(z), keys)
    noise = _t(jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float32))(keys))
    got = TA.find_reasonable_step_size(tvg, torch.as_tensor(z), torch.as_tensor(inv_mass),
                                       init_step=init_step, target=0.8, noise=noise)
    assert got.shape == (c,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert len(set(got.tolist())) > 1  # chains cross at their own steps


def test_vmap_agrees_with_vectorized():
    """sample()'s vectorized default against chain_method='vmap' on the
    conjugate model (mirrors tests/test_vectorized_nuts.py:45, shorter)."""
    model, truth = conjugate_normal_model(num_obs=20)
    kw = dict(kernel=NUTS(max_depth=6), num_samples=400, num_warmup=300, key=0, device="cpu")
    r_vec = sample(model, num_chains=8, **kw)
    r_gen = sample(model, num_chains=4, chain_method="vmap", **kw)
    m_v = float(r_vec.samples["mu"].mean())
    m_g = float(r_gen.samples["mu"].mean())
    assert abs(m_v - truth["post_mean"]) < 0.05
    assert abs(m_g - truth["post_mean"]) < 0.05
    assert abs(m_v - m_g) < 0.05
    assert abs(float(r_gen.samples["mu"].var(unbiased=False)) - truth["post_var"]) < 0.03
    d = r_gen.diagnostics
    assert d["fused_family"] is None  # the per-chain engines take no fused potential
    assert d["step_size"].shape == (4,) and d["inv_mass"].shape == (4, 1)
    assert set(r_gen.stats) == {"accept_prob", "diverging", "energy", "num_steps", "tree_depth"}
    assert r_gen.stats["num_steps"].shape == (4, 400)
    assert d["value_and_grad_calls"] > 0 and d["host_syncs"] > 0


def _logreg():
    x, y, _ = make_logreg_data(100, 5, seed=1)
    return logistic_regression_model(x, y)


@pytest.mark.parametrize("kernel", [NUTS(max_depth=6), HMC(num_integration_steps=6)],
                         ids=["nuts", "hmc"])
def test_per_chain_engine_bit_identical(kernel):
    """Two runs with the same seed give the same bits (mirrors
    tests/test_determinism.py:156)."""
    kw = dict(kernel=kernel, chain_method="vmap", num_chains=2, num_samples=40, num_warmup=40,
              key=3, device="cpu")
    model = _logreg()
    r1, r2 = sample(model, **kw), sample(model, **kw)
    for k in r1.samples:
        assert torch.equal(r1.samples[k], r2.samples[k])
    for k in r1.stats:
        assert torch.equal(r1.stats[k], r2.stats[k])
    assert torch.equal(r1.diagnostics["step_size"], r2.diagnostics["step_size"])


def test_adapt_mass_false_keeps_a_unit_mass():
    model, _ = conjugate_normal_model(num_obs=20)
    kw = dict(kernel=NUTS(max_depth=5), chain_method="vmap", num_chains=3, num_samples=10,
              num_warmup=150, key=1, device="cpu")
    fixed = sample(model, adapt_mass=False, **kw).diagnostics["inv_mass"]
    adapted = sample(model, **kw).diagnostics["inv_mass"]
    assert torch.equal(fixed, torch.ones(3, 1))
    assert not torch.equal(adapted, torch.ones(3, 1))
    # the shared mass: every chain reads the mean of the chains' variances
    assert torch.equal(adapted[0], adapted[2])


def test_kernel_without_make_step_under_vmap_raises():
    model, _ = conjugate_normal_model(num_obs=5)
    with pytest.raises(ValueError, match="requires chain_method='vectorized'"):
        sample(model, kernel=ChEESHMC(), chain_method="vmap", num_samples=5, num_warmup=5,
               num_chains=2, device="cpu")
