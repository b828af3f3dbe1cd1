"""Port parity: one lockstep NUTS transition, held deterministically.

JAX's random stream for a transition is replayed into the port: the
momenta are ``normal(k_mom)`` and, per leaf n, ``fold_in(k_loop, n)`` is
split into the direction, swap and take keys.  With those numbers the
port's transition must reproduce the JAX one: positions, values,
gradients, accept probabilities, divergences and the leaf count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu.inference.vectorized_nuts as JV
import brancher_tpu.ops.pallas_glm as PG
import brancher_torch.inference.vectorized_nuts as TV
import brancher_torch.ops.glm as G

torch.set_num_threads(2)


class JaxStream:
    """The randomness of brancher_tpu's nuts_transition_batched for `key`."""

    def __init__(self, key, c, d, max_depth):
        k_mom, k_loop = jax.random.split(key)
        self.normals = torch.as_tensor(np.array(jax.random.normal(k_mom, (c, d), jnp.float32)))
        self.leaves = {}
        for n in range(1, 2**max_depth):
            k_dir, k_swap, k_take = jax.random.split(jax.random.fold_in(k_loop, n), 3)
            self.leaves[n] = tuple(torch.as_tensor(np.array(a)) for a in (
                jax.random.bernoulli(k_dir, 0.5, (c,)),
                jax.random.uniform(k_swap, (c,)),
                jax.random.uniform(k_take, (c,)),
            ))
        self.used = 0

    def momentum(self, z):
        return self.normals

    def leaf(self, n, c, like):
        self.used = max(self.used, n)
        return self.leaves[n]


def _target(seed):
    rng = np.random.RandomState(seed)
    n, d = 60, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    b = np.zeros(n, np.float32)
    m = np.zeros(d, np.float32)
    iv = np.full(d, 0.5, np.float32)
    jvg = lambda z: PG.bernoulli_vg_reference(z, *map(jnp.asarray, (x, y, b, m, iv)))
    tvg = lambda z: G.bernoulli_vg_reference(z, *map(torch.as_tensor, (x, y, b, m, iv)))
    return jvg, tvg, d


@pytest.mark.parametrize("seed,eps,max_delta", [
    (0, 0.15, 1000.0),   # typical trees
    (1, 0.05, 1000.0),   # small steps: deep trees, several doublings
    (2, 1.2, 3.0),       # large steps and a low threshold: divergences
])
def test_transition_replays_jax_stream(seed, eps, max_delta):
    jvg, tvg, d = _target(seed)
    c, max_depth = 9, 6
    z = np.random.RandomState(10 + seed).normal(0, 0.5, size=(c, d)).astype(np.float32)
    inv_mass = np.linspace(0.7, 1.3, d).astype(np.float32)
    key = jax.random.PRNGKey(seed)

    val, grad = jvg(jnp.asarray(z))
    jz, jv, jg, jap, jdv, jn, jcnt = JV.nuts_transition_batched(
        jvg, jnp.asarray(z), val, grad, jnp.float32(eps), jnp.asarray(inv_mass), key,
        max_depth=max_depth, max_delta_energy=max_delta)

    stream = JaxStream(key, c, d, max_depth)
    tval, tgrad = tvg(torch.as_tensor(z))
    t = TV.nuts_transition_batched(
        tvg, torch.as_tensor(z), tval, tgrad, torch.tensor(eps), torch.as_tensor(inv_mass),
        stream, max_depth=max_depth, max_delta_energy=max_delta)

    assert t.num_leaves == int(jn)
    assert stream.used == int(jn)
    np.testing.assert_array_equal(t.diverging.numpy(), np.asarray(jdv))
    # same arithmetic in f32 along the same tree: agreement to float noise
    np.testing.assert_allclose(t.z.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.val.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t.accept_prob.numpy(), np.asarray(jap), rtol=1e-5, atol=1e-6)
    assert float(t.mean_live) == pytest.approx(float(jcnt), rel=1e-6)
    if seed == 2:
        assert bool(t.diverging.any())


def test_torch_stream_is_reproducible():
    _, tvg, d = _target(0)
    z = torch.zeros((4, d))
    v, g = tvg(z)

    def run():
        rng = TV.TorchNutsRandom(torch.Generator().manual_seed(5))
        return TV.nuts_transition_batched(tvg, z, v, g, torch.tensor(0.3), torch.ones(d), rng,
                                          max_depth=5)

    a, b = run(), run()
    assert torch.equal(a.z, b.z) and a.num_leaves == b.num_leaves
    assert a.host_syncs >= 1 and a.num_leaves <= 31
