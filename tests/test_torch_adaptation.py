"""Port parity: warmup adaptation arithmetic (brancher_torch vs
brancher_tpu.inference.adaptation), exact to float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu.inference.adaptation as JA
import brancher_tpu.ops.pallas_glm as PG
import brancher_torch.inference.adaptation as TA
import brancher_torch.ops.glm as G

torch.set_num_threads(2)


def test_dual_averaging_matches_jax():
    acc = np.random.RandomState(0).uniform(0.2, 1.0, size=40).astype(np.float32)
    restarts = {12, 25}
    js = JA.da_init(jnp.asarray(0.5, jnp.float32))
    ts = TA.da_init(torch.tensor(0.5))
    for i, a in enumerate(acc):
        js = JA.da_update(js, jnp.asarray(a), target_accept=0.85)
        ts = TA.da_update(ts, torch.tensor(a), target_accept=0.85)
        if i in restarts:
            js, ts = JA.da_restart(js), TA.da_restart(ts)
        for field in js._fields:
            # f32 ops; log/pow/sqrt may round differently by an ulp
            np.testing.assert_allclose(float(getattr(ts, field)), float(getattr(js, field)),
                                       rtol=2e-6, atol=1e-6, err_msg=f"{field} @ {i}")
    assert all(getattr(ts, f).dtype == torch.float32 for f in ts._fields)


@pytest.mark.parametrize("w", [0, 1, 7, 50, 149, 150, 151, 500, 1000, 2000])
def test_warmup_schedule_matches_jax(w):
    j_slow, j_end = JA.build_warmup_schedule(w)
    t_slow, t_end = TA.build_warmup_schedule(w)
    np.testing.assert_array_equal(t_slow, j_slow)
    np.testing.assert_array_equal(t_end, j_end)


def _glm(seed=0, n=80, d=4):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    b = np.zeros(n, np.float32)
    m = np.zeros(d, np.float32)
    iv = np.ones(d, np.float32)
    jvg = lambda z: PG.bernoulli_vg_reference(z, *map(jnp.asarray, (x, y, b, m, iv)))
    tvg = lambda z: G.bernoulli_vg_reference(z, *map(torch.as_tensor, (x, y, b, m, iv)))
    return jvg, tvg


@pytest.mark.parametrize("init_step", [1.0, 1e-3], ids=["shrink", "grow"])
def test_find_reasonable_step_size_with_fed_momenta(init_step):
    jvg, tvg = _glm()
    c, d = 16, 4
    z = np.random.RandomState(1).uniform(-2, 2, size=(c, d)).astype(np.float32)
    inv_mass = np.linspace(0.5, 1.5, d).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, (c, d), jnp.float32))  # JAX's own momenta
    step_j = JA.find_reasonable_step_size_batched(
        jvg, jnp.asarray(z), jnp.asarray(inv_mass), key, init_step=init_step)
    step_t = TA.find_reasonable_step_size_batched(
        tvg, torch.as_tensor(z), torch.as_tensor(inv_mass), init_step=init_step,
        noise=torch.as_tensor(noise))
    # the doubling/halving path is discrete: the same number of doublings
    # gives the same power-of-two multiple of init_step
    assert float(step_t) == pytest.approx(float(step_j), rel=1e-6)
    assert float(step_t) != init_step
