"""Port parity: NonCenteredNormalVariable and the non-centered ARD
logistic regression of bench.py (``child_ard``), at a small size.

z follows ravel_pytree's layout: [log tau (D), w_raw (D)]."""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu as BJ
import brancher_tpu.functions as BFJ
import brancher_torch as BT
import brancher_torch.functions as BFT
from brancher_tpu.models import make_logreg_data
from brancher_torch.inference import ChEESHMC, sample

torch.set_num_threads(2)

N, D, TAU_SD = 40, 4, 0.75


def _ard(pkg, bf, asarray):
    """bench.py:195-200 with N=40 rows and D=4 features."""
    x, y, _ = make_logreg_data(N, D, seed=0)
    tau = pkg.LogNormalVariable(asarray(np.zeros(D, np.float32)),
                                asarray(TAU_SD * np.ones(D, np.float32)), "tau")
    w = pkg.NonCenteredNormalVariable(0.0, tau, name="w", shape=(D,))
    yv = pkg.BernoulliVariable(logits=bf.matmul(asarray(x), w), name="y")
    yv.observe(asarray(y))
    return pkg.ProbabilisticModel([yv])


def test_ard_log_density_and_grad_match_jax():
    jc = _ard(BJ, BFJ, jnp.asarray).compiled()
    tc = _ard(BT, BFT, torch.as_tensor).compiled(device="cpu")
    _, unravel = jax.flatten_util.ravel_pytree(jc.z_example())
    assert [name for name, *_ in tc._layout] == ["tau", "w_raw"] and tc.dim == 2 * D
    zs = np.random.RandomState(9).normal(0, 0.5, size=(3, 2 * D)).astype(np.float32)
    v_ref, g_ref = jax.vmap(jax.value_and_grad(
        lambda zf: jc.log_density_z(jc.initial_params, unravel(zf))))(jnp.asarray(zs))
    g_t, v_t = torch.func.vmap(torch.func.grad_and_value(
        lambda zf: tc.log_density_z(tc.initial_params, tc.unravel_z(zf))))(torch.as_tensor(zs))
    # f32 sums over 40 rows in two libraries: 1e-5 of the magnitude
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(v_ref))))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(g_ref))))
    # the deterministic node: w = 0 + tau * w_raw
    vals = tc.constrain(tc.initial_params, tc.unravel_z(torch.as_tensor(zs[0])))
    np.testing.assert_allclose(vals["w"].numpy(), np.exp(zs[0, :D]) * zs[0, D:], rtol=1e-6)


@pytest.mark.parametrize("pkg", [BJ, BT], ids=["jax", "torch"])
def test_shape_guard(pkg):
    a = pkg.NormalVariable(0.0, 1.0, "a")
    b = pkg.LogNormalVariable(0.0, 1.0, "b")
    with pytest.raises(ValueError, match="pass shape= when both"):
        pkg.NonCenteredNormalVariable(a, b, name="w")
    with pytest.raises(ValueError, match="unknown at model-build time"):
        pkg.NonCenteredNormalVariable(0.0, b, name="v")
    # concrete operands set the shape; shape= overrides
    assert pkg.NonCenteredNormalVariable(np.zeros(3), b, name="u").raw.name == "u_raw"
    assert pkg.NonCenteredNormalVariable(0.0, b, name="t", shape=(), raw_name="r").raw.name == "r"


def test_short_chees_run_on_ard():
    model = _ard(BT, BFT, torch.as_tensor)
    res = sample(model, kernel=ChEESHMC(), num_samples=100, num_warmup=100, num_chains=8,
                 key=0, device="cpu", ess_vars=["w", "tau"])
    assert res.diagnostics["fused_family"] is None  # the hierarchy is not a GLM
    for name in ("w", "tau", "w_raw"):
        assert res.samples[name].shape == (8, 100, D)
        assert bool(torch.isfinite(res.samples[name]).all())
    assert set(res.diagnostics["ess"]) == {"w", "tau"}


def _ard_fused(x, y):
    """bench.py:215-227's hand-fused value+grad of the non-centered ARD
    z-density, in torch: z = [log tau (D), w_raw (D)] -> (val [C], grad)."""
    xt, yt = torch.as_tensor(x), torch.as_tensor(y, dtype=torch.float32)
    sd2 = TAU_SD**2

    def fused(zc):
        v, wr = zc[:, :D], zc[:, D:]
        tau = torch.exp(v)
        logits = (wr * tau) @ xt.T
        val = (torch.sum(yt * logits - torch.nn.functional.softplus(logits), -1)
               - 0.5 * torch.sum(v * v, -1) / sd2 - 0.5 * torch.sum(wr * wr, -1))
        s = (yt - torch.sigmoid(logits)) @ xt
        return val, torch.cat([s * wr * tau - v / sd2, s * tau - wr], -1)

    return fused


@pytest.mark.slow  # about 14 s on a CPU, most of it JAX compiling its NUTS
def test_ard_posterior_matches_jax():
    """The small ARD model under both packages' sample() (NUTS, 8 chains,
    300 warmup + 400 draws, target_accept 0.95): the posterior means of w
    and tau agree within 5 Monte-Carlo standard errors (MCSE = sd /
    sqrt(ESS), combined over the two runs).  The port samples with the
    hand-fused potential that chip_smoke.py runs at full width."""
    from brancher_tpu.inference import NUTS as JNUTS
    from brancher_tpu.inference import sample as jsample
    from brancher_torch.inference import NUTS

    x, y, _ = make_logreg_data(N, D, seed=0)
    kw = dict(num_samples=400, num_warmup=300, num_chains=8, target_accept=0.95,
              ess_vars=["w", "tau"])
    jres = jsample(_ard(BJ, BFJ, jnp.asarray), kernel=JNUTS(max_depth=6),
                   key=jax.random.PRNGKey(0), **kw)
    tres = sample(_ard(BT, BFT, torch.as_tensor), kernel=NUTS(max_depth=6), key=1, device="cpu",
                  value_and_grad_fn=_ard_fused(x, y), **kw)
    assert tres.diagnostics["fused_family"] is None
    for name in ("w", "tau"):
        js = np.asarray(jres.samples[name], np.float64)
        ts = tres.samples[name].double().numpy()
        jess = np.asarray(jres.diagnostics["ess"][name])
        tess = tres.diagnostics["ess"][name]
        mcse = np.sqrt(js.var(axis=(0, 1)) / jess + ts.var(axis=(0, 1)) / tess)
        diff = np.abs(ts.mean(axis=(0, 1)) - js.mean(axis=(0, 1)))
        assert np.all(diff < 5 * mcse), (name, diff / mcse)
        assert np.max(tres.diagnostics["r_hat"][name]) < 1.05


def test_ard_fused_potential_matches_autodiff():
    """The torch hand-fused ARD potential against autodiff of the compiled
    log density at three random z, with bench.py:232-239's checks: values
    equal up to a constant (sd < 1e-2), gradients within 2e-3 (1 + |g|)."""
    from brancher_torch.inference.mcmc import autodiff_value_and_grad, make_potential

    x, y, _ = make_logreg_data(N, D, seed=0)
    tc = _ard(BT, BFT, torch.as_tensor).compiled(device="cpu")
    potential, _, _ = make_potential(tc, tc.initial_params)
    zp = 0.5 * torch.randn((3, 2 * D), generator=torch.Generator().manual_seed(9))
    va, ga = autodiff_value_and_grad(potential)(zp)
    vf, gf = _ard_fused(x, y)(zp)
    assert float(torch.std(vf - va)) < 1e-2
    assert bool(torch.all(torch.abs(gf - ga) <= 2e-3 * (1.0 + torch.abs(ga))))
