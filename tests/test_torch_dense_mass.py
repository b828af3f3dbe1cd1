"""Port parity: ``sample(mass="dense")``.

Stage B's whitening is deterministic given stage A's draws: the mean, the
covariance (ddof 1, plus 1e-6 I), its Cholesky factor L, the whitened
start and the wrapped value+grad ``(v, g @ L)`` at ``mu + zt @ L.T`` are
held to JAX's arithmetic (``brancher_tpu/inference/mcmc.py:826-846``),
and one stage-B NUTS transition to JAX's with JAX's numbers fed in.  Whole
runs are held to the JAX test's limits on a correlated Gaussian
(``tests/test_vectorized_nuts.py:164``)."""
import jax
import jax.numpy as jnp
import jax.scipy.linalg
import numpy as np
import pytest
import torch

import brancher_tpu.inference.vectorized_nuts as JV
import brancher_tpu.ops.pallas_glm as PG
import brancher_torch.inference.mcmc as TM
import brancher_torch.inference.vectorized_nuts as TV
import brancher_torch.ops.glm as G
from brancher_torch import NormalVariable, ProbabilisticModel
from brancher_torch.inference import NUTS, sample
from test_torch_nuts import JaxStream

torch.set_num_threads(2)


def _glm(seed=0, n=60, d=3):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    b = np.zeros(n, np.float32)
    m = np.zeros(d, np.float32)
    iv = np.full(d, 0.5, np.float32)
    jvg = lambda z: PG.bernoulli_vg_reference(z, *map(jnp.asarray, (x, y, b, m, iv)))
    tvg = lambda z: G.bernoulli_vg_reference(z, *map(torch.as_tensor, (x, y, b, m, iv)))
    return jvg, tvg, d


def _stage_a_draws(c=6, s=50, d=3):
    """Correlated draws standing in for stage A's [C, S, d]."""
    a = np.asarray([[1.0, 0.0, 0.0], [0.8, 0.6, 0.0], [0.3, -0.5, 0.4]], np.float32)
    z = np.random.RandomState(1).normal(size=(c, s, d)).astype(np.float32)
    return (z @ a.T + np.asarray([0.5, -1.0, 2.0], np.float32)).astype(np.float32)


def _jax_stage_b(zs_a, jvg):
    """brancher_tpu/inference/mcmc.py:826-846, the statistics and build_stage_b."""
    flat = jnp.asarray(zs_a).reshape(-1, zs_a.shape[-1])
    dim = flat.shape[-1]
    mu = jnp.mean(flat, axis=0)
    cov = jnp.cov(flat.T).reshape(dim, dim) + 1e-6 * jnp.eye(dim)
    chol = jnp.linalg.cholesky(cov)
    z_last = jnp.asarray(zs_a[:, -1])
    zt0 = jax.scipy.linalg.solve_triangular(chol, (z_last - mu[None, :]).T, lower=True).T

    def vg_t(zt):
        v, g = jvg(mu[None, :] + zt @ chol.T)
        return v, g @ chol

    return mu, cov, chol, zt0, vg_t


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def test_stage_b_statistics_and_wrapper_match_jax():
    jvg, tvg, d = _glm()
    zs_a = _stage_a_draws(d=d)
    jmu, jcov, jchol, jzt0, jvg_t = _jax_stage_b(zs_a, jvg)
    mu, cov, chol = TM.dense_statistics(torch.as_tensor(zs_a))
    zt0 = TM.whitened(torch.as_tensor(zs_a[:, -1]), mu, chol)
    tvg_t = TM.whiten(tvg, mu, chol)
    for got, want in ((mu, jmu), (cov, jcov), (chol, jchol), (zt0, jzt0)):
        _close(got, want)
    # the wrapped value+grad at the whitened start and two other points
    pts = [np.array(jzt0)] + [np.random.RandomState(s).normal(size=zt0.shape).astype(np.float32)
                                for s in (2, 3)]
    for zt in pts:
        jv, jg = jvg_t(jnp.asarray(zt))
        tv, tg = tvg_t(torch.as_tensor(zt))
        scale = max(1.0, float(np.abs(jv).max()))
        _close(tv, jv, atol=1e-5 * scale)
        _close(tg, jg, atol=1e-5 * max(1.0, float(np.abs(jg).max())))


@pytest.mark.parametrize("seed,eps", [(0, 0.3), (1, 0.08)])
def test_stage_b_transition_replays_jax(seed, eps):
    """One lockstep NUTS transition in whitened coordinates, JAX's numbers
    fed in (the stream of tests/test_torch_nuts.py)."""
    jvg, tvg, d = _glm(seed)
    zs_a = _stage_a_draws(d=d)
    jmu, _, jchol, jzt0, jvg_t = _jax_stage_b(zs_a, jvg)
    mu, _, chol = TM.dense_statistics(torch.as_tensor(zs_a))
    zt0 = TM.whitened(torch.as_tensor(zs_a[:, -1]), mu, chol)
    tvg_t = TM.whiten(tvg, mu, chol)
    c, max_depth = zt0.shape[0], 6
    inv_mass = np.linspace(0.8, 1.2, d).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jval, jgrad = jvg_t(jzt0)
    jz, jv, jg, jap, jdv, jn, _ = JV.nuts_transition_batched(
        jvg_t, jzt0, jval, jgrad, jnp.float32(eps), jnp.asarray(inv_mass), key, max_depth=max_depth)
    tval, tgrad = tvg_t(zt0)
    t = TV.nuts_transition_batched(tvg_t, zt0, tval, tgrad, torch.tensor(eps),
                                   torch.as_tensor(inv_mass), JaxStream(key, c, d, max_depth),
                                   max_depth=max_depth)
    assert t.num_leaves == int(jn)
    np.testing.assert_array_equal(t.diverging.numpy(), np.asarray(jdv))
    _close(t.z, jz)
    _close(t.val, jv, atol=1e-4)
    _close(t.grad, jg, atol=1e-4)
    _close(t.accept_prob, jap, atol=1e-6)
    # back in the model's coordinates, as sample() reports the draws
    _close(mu[None] + t.z @ chol.T, np.asarray(jmu)[None] + np.asarray(jz) @ np.asarray(jchol).T)


def _correlated_2d(rho=0.99, sd=(1.0, 1.0)):
    """z2 ~ N(rho sd2/sd1 z1, sd2 sqrt(1 - rho^2)): corr(z1, z2) = rho
    (tests/test_io_aux.py:61-65; the port has no MultivariateNormal yet)."""
    z1 = NormalVariable(0.0, sd[0], "z1")
    z2 = NormalVariable(rho * (sd[1] / sd[0]) * z1, float(sd[1] * np.sqrt(1 - rho**2)), "z2")
    return ProbabilisticModel([z1, z2])


@pytest.mark.slow  # about 75 s on a CPU: the diagonal run's deep trees
def test_dense_mass_preconditioning_correlated_target():
    """Mirrors tests/test_vectorized_nuts.py:164 on the 2-D correlated
    Gaussian: dense min-ESS over twice the diagonal's, and the posterior
    covariance recovered within 0.15."""
    rho = 0.99
    model = _correlated_2d(rho)
    kw = dict(kernel=NUTS(max_depth=7), num_samples=400, num_warmup=400, num_chains=8, key=0,
              device="cpu")
    res_diag = sample(model, mass="diag", **kw)
    res_dense = sample(model, mass="dense", **kw)
    ess = {r: min(float(np.min(v)) for v in res.diagnostics["ess"].values())
           for r, res in (("diag", res_diag), ("dense", res_dense))}
    assert ess["dense"] > 2.0 * ess["diag"], ess
    draws = torch.stack([res_dense.samples["z1"], res_dense.samples["z2"]], -1).reshape(-1, 2)
    np.testing.assert_allclose(np.cov(draws.numpy().T), [[1.0, rho], [rho, 1.0]], atol=0.15)
    assert res_dense.diagnostics["inv_mass"].shape == (2, 2)


def test_dense_run_reports_a_square_mass_and_both_stages():
    model = _correlated_2d(0.8, (1.0, 2.0))
    res = sample(model, kernel=NUTS(max_depth=5), mass="dense", num_samples=60, num_warmup=120,
                 num_chains=4, key=1, device="cpu")
    d = res.diagnostics
    assert d["inv_mass"].shape == (2, 2)
    assert torch.allclose(d["inv_mass"], d["inv_mass"].T)
    stage_a = d["dense_stage_a"]
    # stage A: half the warmup (at least 50), clamp(num_samples, 50, 200) draws
    assert (stage_a["num_warmup"], stage_a["num_samples"]) == (60, 60)
    # every value+grad call of both stages went through the counted one
    assert 0 < stage_a["value_and_grad_calls"] < d["value_and_grad_calls"]
    assert res.samples["z1"].shape == (4, 60)
    rs = d["resume_state"]
    assert rs["dense_L"].shape == (2, 2) and rs["dense_inner_inv_mass"].shape == (2,)
    assert torch.allclose(rs["dense_L"] @ rs["dense_L"].T, d["inv_mass"], atol=1e-5)


def test_dense_without_warmup_samples_with_diagonal_mass():
    """JAX silently samples with diagonal mass when mass='dense' has no
    warmup and no resume (brancher_tpu/inference/mcmc.py:795)."""
    model = _correlated_2d(0.5)
    kw = dict(kernel=NUTS(max_depth=4), num_samples=20, num_warmup=0, num_chains=3, key=2,
              device="cpu")
    dense, diag = sample(model, mass="dense", **kw), sample(model, **kw)
    assert dense.diagnostics["inv_mass"].shape == (2,)
    assert "dense_stage_a" not in dense.diagnostics and "dense_mu" not in dense.diagnostics["resume_state"]
    assert torch.equal(dense.samples["z1"], diag.samples["z1"])


def test_dense_with_a_per_chain_method_raises():
    with pytest.raises(ValueError, match="mass='dense' requires chain_method='vectorized'"):
        sample(_correlated_2d(0.5), kernel=NUTS(max_depth=3), mass="dense", chain_method="vmap",
               num_samples=5, num_warmup=5, num_chains=2, device="cpu")
