"""Port parity: particle VI (brancher_torch.inference.particle_inference_tools
against brancher_tpu's).  The transport pieces on the same inputs; WVGD and
SVGD iterations replaying JAX's numbers (its prior particles, proposal
picks and noise); and the conjugate posterior's moments."""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu as BJ
import brancher_tpu.functions as BFJ
import brancher_tpu.inference.particle_inference_tools as JP
import brancher_torch as BT
import brancher_torch.functions as BFT
import brancher_torch.inference.particle_inference_tools as TP
from brancher_torch.inference import perform_inference
from brancher_torch.inference.svi import (
    SteinVariationalGradientDescent,
    WassersteinVariationalGradientDescent,
)
from brancher_torch.models import conjugate_normal_model

torch.set_num_threads(2)

# f32 arithmetic in two libraries: within 1e-5 of the larger of 1 and the
# result's largest magnitude (sums of up to a few thousand terms)
RTOL = 1e-5


def _close(got, ref, what="", rtol=RTOL):
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0, atol=rtol * scale,
                               err_msg=what)


_rng = np.random.RandomState(0)
_X = _rng.normal(size=(200, 3)).astype(np.float32)
_Z = _rng.normal(size=(12, 3)).astype(np.float32)
_W = np.exp(_rng.normal(size=200)).astype(np.float32)
_W /= _W.sum()
_COST = ((_X[:, None, :] - _Z[None, :, :]) ** 2).sum(-1).astype(np.float32)


def test_sinkhorn_plan_matches_jax_and_its_marginals():
    ref = JP.sinkhorn_plan(jnp.asarray(_COST), jnp.log(jnp.asarray(_W)), jnp.asarray(0.5), iters=60)
    got = TP.sinkhorn_plan(torch.as_tensor(_COST), torch.log(torch.as_tensor(_W)),
                           torch.tensor(0.5), iters=60)
    _close(got.numpy(), ref)
    # tests/test_particles.py's marginals, to its 5e-4
    np.testing.assert_allclose(got.sum(0).numpy(), np.full(12, 1 / 12), atol=5e-4)
    np.testing.assert_allclose(got.sum(1).numpy(), _W, atol=5e-4)


def test_dual_ascent_matches_jax():
    psi0 = _rng.normal(0, 0.1, size=12).astype(np.float32)
    ref = JP.dual_ascent_psi(jnp.asarray(_COST), jnp.asarray(_W), jnp.asarray(psi0), 0.7, iters=40)
    got = TP.dual_ascent_psi(torch.as_tensor(_COST), torch.as_tensor(_W), torch.as_tensor(psi0),
                             0.7, iters=40)
    _close(got.numpy(), ref)


def test_voronoi_set_matches_jax():
    psi = _rng.normal(0, 0.5, size=12).astype(np.float32)
    for power in (None, psi):
        js = JP.VoronoiSet(jnp.asarray(_Z), None if power is None else jnp.asarray(power))
        ts = TP.VoronoiSet(torch.as_tensor(_Z), None if power is None else torch.as_tensor(power))
        np.testing.assert_array_equal(ts.assign(torch.as_tensor(_X)).numpy(),
                                      np.asarray(js.assign(jnp.asarray(_X))))
        np.testing.assert_array_equal(ts.cell_counts(torch.as_tensor(_X)).numpy(),
                                      np.asarray(js.cell_counts(jnp.asarray(_X))))
        _close(ts.cell_masses(torch.as_tensor(_X), torch.as_tensor(_W)).numpy(),
               js.cell_masses(jnp.asarray(_X), jnp.asarray(_W)))
        for got, ref in zip(ts.cell_barycenters(torch.as_tensor(_X), torch.as_tensor(_W)),
                            js.cell_barycenters(jnp.asarray(_X), jnp.asarray(_W))):
            _close(got.numpy(), ref)
    # an empty cell keeps its center
    far = np.concatenate([_Z, [[50.0, 50.0, 50.0]]]).astype(np.float32)
    bary, mass = TP.VoronoiSet(torch.as_tensor(far)).cell_barycenters(
        torch.as_tensor(_X), torch.as_tensor(_W))
    assert float(mass[-1]) == 0.0 and np.allclose(bary[-1].numpy(), 50.0)


@pytest.mark.parametrize("bandwidth", [None, 0.8])
def test_particle_update_matches_jax(bandwidth):
    g = _rng.normal(size=(12, 3)).astype(np.float32)
    ref = JP.particle_update(jnp.asarray(_Z), jnp.asarray(g), bandwidth)
    got = TP.particle_update(torch.as_tensor(_Z), torch.as_tensor(g), bandwidth)
    _close(got.numpy(), ref)
    # the median heuristic takes numpy's median (an even count: the mean of
    # the middle two)
    _close(TP._median_bandwidth(torch.as_tensor(_Z)).numpy(), JP._median_bandwidth(jnp.asarray(_Z)))


def _regression(pkg, bf):
    rng = np.random.RandomState(1)
    x = rng.normal(size=(15, 2)).astype(np.float32)
    y = (x @ np.float32([0.7, -0.4]) + 0.5 * rng.normal(size=15)).astype(np.float32)
    w = pkg.NormalVariable(np.zeros(2, np.float32), np.ones(2, np.float32), "w")
    s = pkg.LogNormalVariable(0.0, 0.5, "s")
    yv = pkg.NormalVariable(bf.matmul(x, w), s, "y")
    yv.observe(y)
    return pkg.ProbabilisticModel([yv])


def _jax_prior_particles(comp, key, p):
    """JAX's initial particles (run_wvgd / run_svgd's prior_z over P keys)."""
    params = comp.initial_params

    def prior_z(k):
        vals = comp.sample_one(params, k)
        latents = {n: vals[n] for n in comp.continuous_latent_names}
        return jax.flatten_util.ravel_pytree(comp.unconstrain(params, latents))[0]

    k_init, k_run = jax.random.split(key)
    return np.asarray(jax.vmap(prior_z)(jax.random.split(k_init, p))), k_run


@pytest.mark.parametrize("method", ["sinkhorn", "exact"])
def test_wvgd_iterations_replay_jax(method):
    p, m, iters = 16, 128, 2
    key = jax.random.PRNGKey(3)
    jm = _regression(BJ, BFJ)
    ref = JP.run_wvgd(jm, number_iterations=iters, number_particles=p, lr=0.3, key=key,
                      number_samples=m, method=method, psi_lr=0.8)
    z0, k_run = _jax_prior_particles(jm.compiled(), key, p)
    draws = []
    for k in jax.random.split(k_run, iters):
        k_pick, k_noise = jax.random.split(k)
        draws.append((torch.as_tensor(np.asarray(jax.random.randint(k_pick, (m,), 0, p))).long(),
                      torch.as_tensor(np.asarray(jax.random.normal(k_noise, (m, 3))))))
    got = TP.run_wvgd(_regression(BT, BFT), number_iterations=iters, number_particles=p, lr=0.3,
                      number_samples=m, method=method, psi_lr=0.8, device="cpu",
                      init_z=torch.as_tensor(z0), draw_fn=lambda t: draws[t])
    _close(got.params["particles_z"].numpy(), ref.params["particles_z"], "particles")
    _close(got.loss_curve, ref.loss_curve, "transport cost")
    for k in ("w", "s"):
        _close(got.extras["particles"][k].numpy(), ref.extras["particles"][k], k)


def test_svgd_iterations_replay_jax():
    """Adam's bias corrections are f32 in optax and float64 in torch
    (ROADMAP queue 3): a step may differ by lr x 2.5e-5, so the particles
    are held to 1e-4 of their scale."""
    p, iters = 16, 3
    key = jax.random.PRNGKey(4)
    jm = _regression(BJ, BFJ)
    ref = JP.run_svgd(jm, number_iterations=iters, number_particles=p, lr=0.05, key=key)
    z0, _ = _jax_prior_particles(jm.compiled(), key, p)
    got = TP.run_svgd(_regression(BT, BFT), number_iterations=iters, number_particles=p, lr=0.05,
                      device="cpu", init_z=torch.as_tensor(z0))
    _close(got.params["particles_z"].numpy(), ref.params["particles_z"], "particles", rtol=1e-4)
    _close(got.loss_curve, ref.loss_curve, "loss", rtol=1e-4)


def test_svgd_matches_conjugate():
    """tests/test_particles.py's SVGD check and limits."""
    model, truth = conjugate_normal_model(num_obs=20)
    res = perform_inference(model, number_iterations=400, lr=0.05, key=0, device="cpu",
                            inference_method=SteinVariationalGradientDescent(number_particles=64))
    particles = res.extras["particles"]["mu"].double().numpy()
    assert abs(particles.mean() - truth["post_mean"]) < 0.1
    assert abs(particles.var() - truth["post_var"]) < 0.04
    assert model.diagnostics["loss curve"] is res.loss_curve


@pytest.mark.slow
def test_wvgd_matches_conjugate():
    """tests/test_particles.py's WVGD check and limits (about 11 s on the CPU)."""
    model, truth = conjugate_normal_model(num_obs=20)
    res = perform_inference(model, number_iterations=600, lr=0.15, key=0, device="cpu",
                            inference_method=WassersteinVariationalGradientDescent(number_particles=64))
    particles = res.extras["particles"]["mu"].double().numpy()
    assert abs(particles.mean() - truth["post_mean"]) < 0.1
    assert abs(particles.var() - truth["post_var"]) < 0.04
    assert res.loss_curve[-1] < res.loss_curve[0]


def test_wvgd_and_svgd_are_distinct_paths_and_refuse_an_unknown_method():
    assert TP.run_wvgd is not TP.run_svgd
    model, _ = conjugate_normal_model(num_obs=5)
    with pytest.raises(ValueError, match="unknown WVGD method"):
        TP.run_wvgd(model, number_iterations=1, method="greedy", device="cpu")
