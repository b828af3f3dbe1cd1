"""Port parity: the Gaussian-process sugar (brancher_torch.stochastic_processes
against brancher_tpu's): the kernels, the GP prior's covariance and
log-density, and a hyperprior through the links."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu as BJ
import brancher_tpu.stochastic_processes as JS
import brancher_torch as BT
import brancher_torch.stochastic_processes as TS

torch.set_num_threads(2)

# f32 exp, sqrt, Cholesky and a triangular solve in two libraries: within
# 1e-5 of the larger of 1 and the result's largest magnitude
RTOL = 1e-5


def _close(got, ref, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0, atol=RTOL * scale,
                               err_msg=what)


_rng = np.random.RandomState(0)


@pytest.mark.parametrize("kernel", ["rbf_kernel", "matern32_kernel"])
@pytest.mark.parametrize("shape", [(12,), (9, 2)])
def test_kernels_match_jax(kernel, shape):
    x = _rng.uniform(0, 2, size=shape).astype(np.float32)
    ref = getattr(JS, kernel)(jnp.asarray(x), 0.45, 1.7)
    got = getattr(TS, kernel)(torch.as_tensor(x), 0.45, 1.7)
    _close(got.numpy(), ref)
    # symmetric, with the variance on the diagonal (matern's up to its 1e-12 shift)
    np.testing.assert_allclose(got.numpy(), got.numpy().T, atol=1e-7)
    np.testing.assert_allclose(np.diag(got.numpy()), 1.7, rtol=1e-5)


def _gp_model(pkg, sp, xs):
    ls = pkg.LogNormalVariable(-1.0, 0.3, "ls")
    f = sp.GaussianProcess(xs, lengthscale=ls, variance=1.3, name="f", kernel="matern32", mean=0.2)
    y = pkg.NormalVariable(f, 0.1, "y")
    y.observe(np.sin(2 * xs).astype(np.float32))
    return pkg.ProbabilisticModel([y])


def test_gp_covariance_and_log_density_match_jax():
    xs = np.linspace(0, 1, 8).astype(np.float32)
    jc = _gp_model(BJ, JS, xs).compiled()
    tc = _gp_model(BT, TS, xs).compiled("cpu")
    assert tc.shapes["f"] == tuple(jc.shapes["f"]) == (8,)
    # the covariance the GP's MVN reads: the Gram matrix plus 1e-5 I
    fv = next(v for v in tc.order if v.name == "f")
    cov = fv.eval_params({"ls": torch.tensor(0.4)}, tc._as_store(tc.initial_params))["covariance_matrix"]
    expect = np.asarray(JS.matern32_kernel(jnp.asarray(xs), 0.4, 1.3)) + 1e-5 * np.eye(8)
    _close(cov.numpy(), expect)
    # the joint log-density and its gradient in z, hyperprior included
    z = {"ls": np.float32(-0.7), "f": _rng.normal(0, 0.8, size=8).astype(np.float32)}
    ref, ref_g = jax.value_and_grad(lambda zz: jc.log_density_z(jc.initial_params, zz))(
        {k: jnp.asarray(v) for k, v in z.items()})
    zt = {k: torch.as_tensor(v).requires_grad_(True) for k, v in z.items()}
    got = tc.log_density_z(tc.initial_params, zt)
    _close(got.detach().numpy(), ref)
    for (k, t), g in zip(zt.items(), torch.autograd.grad(got, list(zt.values()))):
        _close(g.numpy(), ref_g[k], f"d/d{k}")


def test_gp_prior_draws_with_a_hyperprior():
    """tests/test_gp.py::test_gp_hyperprior: the lengthscale as a latent
    composes through the link."""
    xs = np.linspace(0, 1, 8).astype(np.float32)
    ls = BT.LogNormalVariable(-1.0, 0.3, "ls")
    f = TS.GaussianProcess(xs, lengthscale=ls, variance=1.0, name="f")
    s = BT.ProbabilisticModel([f]).get_sample_dict(5, key=0, device="cpu")
    assert s["f"].shape == (5, 8) and bool(torch.isfinite(s["f"]).all())


def test_a_covariance_that_is_not_positive_definite_gives_nan():
    """jnp.linalg.cholesky gives NaN there; the port's MVN does too, with
    no wait for the device to check the factorisation."""
    from brancher_torch.distributions import MultivariateNormal

    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    lp = MultivariateNormal().log_prob(torch.zeros(2), loc=torch.zeros(2), covariance_matrix=bad)
    assert torch.isnan(lp)


def test_gp_prior_covariance():
    """tests/test_gp.py::test_gp_prior_covariance: 4000 prior draws, their
    covariance within its 0.25 of the kernel."""
    xs = np.linspace(0, 1, 10).astype(np.float32)
    f = TS.GaussianProcess(xs, lengthscale=0.3, variance=2.0, name="f")
    s = BT.ProbabilisticModel([f]).get_sample_dict(4000, key=0, device="cpu")
    emp = np.cov(s["f"].numpy().T)
    np.testing.assert_allclose(emp, TS.rbf_kernel(torch.as_tensor(xs), 0.3, 2.0).numpy(), atol=0.25)
