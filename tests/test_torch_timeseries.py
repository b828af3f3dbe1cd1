"""Port parity: the time-series variables (brancher_torch vs brancher_tpu).

AR(p), Markov-series and LGSSM log-densities, masked series included, are
held to JAX's at rtol 1e-5 (f32 sums over up to a few hundred terms in two
libraries), values and gradients in unconstrained space; the port's AR(2)
sampler is held to the stationary variance with the JAX test's limit
(tests/test_timeseries.py:31-41)."""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_torch as BT
import brancher_tpu as BJ
import brancher_torch.stochastic_processes as TS
import brancher_tpu.stochastic_processes as JS
from brancher_torch.distributions import Normal as TNormal
from brancher_tpu.distributions import Normal as JNormal
from brancher_torch.models import ar_model as t_ar_model
from brancher_torch.models import lgssm_model as t_lgssm_model
from brancher_tpu.models.autoregressive import ar_model as j_ar_model
from brancher_tpu.models.autoregressive import make_ar_data
from brancher_tpu.models.state_space import LGSSMParams, lgssm_model as j_lgssm_model
from brancher_tpu.models.state_space import make_lgssm_data

torch.set_num_threads(2)
RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _log_prob_one(model_j, model_t, values):
    jc, tc = model_j.compiled(), model_t.compiled(device="cpu")
    lj = jc.log_prob_one(jc.initial_params, {k: jnp.asarray(v) for k, v in values.items()})
    lt = tc.log_prob_one(tc.initial_params, {k: torch.as_tensor(v) for k, v in values.items()})
    return float(lt), float(lj)


def _density_z(jm, tm, seed=1, n=4):
    """log_density_z and its gradient at the same random z in both packages."""
    jc, tc = jm.compiled(), tm.compiled(device="cpu")
    z0, unravel = jax.flatten_util.ravel_pytree(jc.z_example())
    assert tc.dim == z0.shape[0]
    zs = np.random.RandomState(seed).normal(0, 0.5, size=(n, tc.dim)).astype(np.float32)
    v_j, g_j = jax.vmap(jax.value_and_grad(
        lambda zf: jc.log_density_z(jc.initial_params, unravel(zf))))(jnp.asarray(zs))
    g_t, v_t = torch.func.vmap(torch.func.grad_and_value(
        lambda zf: tc.log_density_z(tc.initial_params, tc.unravel_z(zf))))(torch.as_tensor(zs))
    return (v_t, g_t), (v_j, g_j)


@pytest.mark.parametrize("coeffs", [(0.6,), (0.5, 0.2)], ids=["ar1", "ar2"])
def test_ar_log_prob_matches_jax(coeffs):
    data = make_ar_data(length=80, coeffs=coeffs, noise=0.4, seed=0)
    c = np.asarray(coeffs, np.float32)

    def model(pkg, sp):
        s = sp.ARProcess(80, c, 0.4, name="s", order=len(coeffs), bias=0.1,
                         init_loc=0.2, init_scale=1.3)
        return pkg.ProbabilisticModel([s])

    lt, lj = _log_prob_one(model(BJ, JS), model(BT, TS), {"s": data})
    _close(lt, lj)


@pytest.mark.parametrize("order", [1, 2])
def test_ar_model_density_z_matches_jax(order):
    """ar_model: coefficients and noise latent (the NUTS target)."""
    data = make_ar_data(length=120, coeffs=(0.5, 0.2)[:order], noise=0.3, seed=2)
    (v_t, g_t), (v_j, g_j) = _density_z(j_ar_model(data, order), t_ar_model(data, order))
    _close(v_t, v_j)
    _close(g_t, g_j)


def test_markov_process_log_prob_matches_jax():
    x = np.random.RandomState(0).normal(size=30).astype(np.float32)

    def model(pkg, sp, normal):
        v = sp.MarkovProcess(30, normal(), lambda prev, a: {"loc": a * prev, "scale": 0.5},
                             links={"a": 0.8}, init_links={"loc": 0.3, "scale": 1.2},
                             init_dist=normal(), name="x")
        return pkg.ProbabilisticModel([v])

    lt, lj = _log_prob_one(model(BJ, JS, JNormal), model(BT, TS, TNormal), {"x": x})
    _close(lt, lj)


def test_markov_process_with_a_latent_link_matches_jax():
    """A Markov chain whose transition coefficient is latent, observed."""
    x = np.random.RandomState(1).normal(size=40).astype(np.float32)

    def model(pkg, sp, normal):
        a = pkg.NormalVariable(0.0, 0.5, "a")
        v = sp.MarkovProcess(40, normal(), lambda prev, a: {"loc": a * prev, "scale": 0.7},
                             links={"a": a}, init_links={"loc": 0.0, "scale": 1.0},
                             init_dist=normal(), name="x")
        v.observe(x)
        return pkg.ProbabilisticModel([v])

    (v_t, g_t), (v_j, g_j) = _density_z(model(BJ, JS, JNormal), model(BT, TS, TNormal))
    _close(v_t, v_j)
    _close(g_t, g_j)


def test_lgssm_dsl_model_log_prob_matches_jax():
    params = LGSSMParams()
    xs, ys = make_lgssm_data(length=20, params=params, seed=3)
    lt, lj = _log_prob_one(j_lgssm_model(ys, params), t_lgssm_model(ys, params), {"x": xs})
    _close(lt, lj)


def _gappy_ar2(seed=1):
    data = make_ar_data(length=150, coeffs=(0.5, 0.2), noise=0.3, seed=0).copy()
    holes = np.random.RandomState(seed).choice(150, size=15, replace=False)
    data[holes] = np.nan
    return data


def _masked_ar2(pkg, sp, data):
    coeffs = pkg.NormalVariable(np.zeros(2, np.float32), 0.5 * np.ones(2, np.float32), "coeffs")
    noise = pkg.LogNormalVariable(-1.0, 0.5, "noise_scale")
    series = sp.ARProcess(len(data), coeffs, noise, name="series", order=2)
    sp.observe_timeseries(series, data)
    return pkg.ProbabilisticModel([series]), series


def test_observe_timeseries_masks_like_jax():
    """NaN gaps in an AR(2) series: the same mask (a term drops when x_t or
    one of its two lags is missing) and the same masked log-density."""
    data = _gappy_ar2()
    jm, jser = _masked_ar2(BJ, JS, data)
    tm, tser = _masked_ar2(BT, TS, data)
    np.testing.assert_array_equal(tser.log_prob_mask.numpy(), np.asarray(jser.log_prob_mask))
    assert 0 < float(tser.log_prob_mask.sum()) < 150 - 15
    (v_t, g_t), (v_j, g_j) = _density_z(jm, tm)
    _close(v_t, v_j)
    _close(g_t, g_j)
    # the masked terms really drop: the unmasked density differs
    del tser.log_prob_mask
    (v_u, _), _ = _density_z(jm, tm)
    assert float(torch.max(torch.abs(v_u - v_t))) > 1.0


def test_ar2_sampling_stationary():
    """The port's AR(2) sampler, four series of 4000 steps, against the
    stationary variance (the JAX test's limit, rtol 0.15)."""
    c1, c2, s = 0.5, 0.2, 0.3
    series = TS.ARProcess(4000, np.asarray([c1, c2], np.float32), s, name="s", order=2,
                          init_loc=0.0, init_scale=0.5)
    vals = BT.ProbabilisticModel([series]).get_sample_dict(4, key=0, device="cpu")
    assert tuple(vals["s"].shape) == (4, 4000)
    x = vals["s"][:, 500:].numpy()  # transient dropped
    g0 = s**2 * (1 - c2) / ((1 + c2) * ((1 - c2) ** 2 - c1**2))
    np.testing.assert_allclose(np.var(x), g0, rtol=0.15)


def test_markov_process_samples_and_scores():
    x = TS.MarkovProcess(30, TNormal(), lambda prev, a: {"loc": a * prev, "scale": 0.5},
                         links={"a": 0.8}, init_links={"loc": 0.0, "scale": 1.0},
                         init_dist=TNormal(), name="x")
    model = BT.ProbabilisticModel([x])
    vals = model.get_sample_dict(3, key=0, device="cpu")
    assert tuple(vals["x"].shape) == (3, 30)
    lp = model.compiled("cpu").log_prob(model.compiled("cpu").initial_params, vals)
    assert lp.shape == (3,) and bool(torch.isfinite(lp).all())


def test_timeseries_helper_masks():
    vals, mask = TS.Timeseries(np.asarray([1.0, np.nan, 3.0], np.float32))
    j_vals, j_mask = JS.Timeseries(np.asarray([1.0, np.nan, 3.0], np.float32))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
