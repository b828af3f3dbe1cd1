"""Port parity: the recognizer's AutoRegressive branch (brancher_torch vs
brancher_tpu, ``pallas_glm.py:865-890``).

An observed AR(p) series is the normal_learned family over its lag
matrix.  The extracted family is held to JAX's at 1e-6 (the lag matrix,
y and u are copies of the data; b, c0 and the prior come from f32 probes
of the same graph), its plain value+grad to JAX's family run through the
Pallas kernel in interpret mode at 1e-5 (f32; bf16 at the bf16 limit of
tests/test_torch_glm.py), and a series with a missing-data mask is left
unrecognized by both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_torch as BT
import brancher_tpu as BJ
import brancher_torch.ops.glm as G
import brancher_tpu.ops.pallas_glm as PG
import brancher_torch.stochastic_processes as TS
import brancher_tpu.stochastic_processes as JS
from brancher_torch.models import ar_model as t_ar_model
from brancher_tpu.models.autoregressive import ar_model as j_ar_model
from brancher_tpu.models.autoregressive import make_ar_data

torch.set_num_threads(2)
TOL = {"f32": 1e-5, "bf16": 2e-3}


def _families(order, length=300):
    data = make_ar_data(length, (0.7,) if order == 1 else (0.5, 0.2), 0.3, seed=0)
    jc = j_ar_model(data, order).compiled()
    tc = t_ar_model(data, order).compiled(device="cpu")
    return PG.recognize_fused_family(jc, jc.initial_params), \
        G.recognize_fused_family(tc, tc.initial_params), tc


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.max(np.abs(ref))), 1.0))


@pytest.mark.parametrize("order", [1, 2])
def test_ar_family_matches_jax(order):
    jf, tf, tc = _families(order)
    assert jf is not None and tf is not None
    assert tf.family == jf.family == "normal_learned"
    d = order + 1  # z = [coeffs (order), log noise_scale]
    assert tc.dim == d and tuple(tf.x.shape) == (300 - order, d)
    for field in ("x", "y", "b", "u", "prior_mean", "prior_inv_var"):
        np.testing.assert_allclose(getattr(tf, field).numpy(), np.asarray(getattr(jf, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)
    assert tf.c0 == pytest.approx(jf.c0, abs=1e-6)
    assert tf.ll_scale == jf.ll_scale
    # the noise coordinate's column of X is zero, and u selects it
    assert float(tf.x[:, -1].abs().max()) == 0.0
    np.testing.assert_allclose(tf.u.numpy(), np.eye(d, dtype=np.float32)[-1], atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("order", [1, 2])
def test_ar_family_value_and_grad_matches_pallas_interpret(order, dtype):
    """The port's plain version on its family against JAX's family through
    the TPU kernel, run as tests/test_pallas_glm.py runs it on the CPU."""
    jf, tf, tc = _families(order)
    z = np.random.RandomState(3).normal(0, 0.3, size=(13, tc.dim)).astype(np.float32)
    z[:, -1] += np.log(0.3)  # noise scale near the data's
    v_p, g_p = PG.normal_vg_pallas(jnp.asarray(z), jf.x, jf.y, jf.b, jf.u, jf.c0,
                                   jf.prior_mean, jf.prior_inv_var, ll_scale=jf.ll_scale,
                                   block_rows=256, interpret=True, dtype=dtype)
    data = G.build_glm_data(tf.family, tf.x, tf.y, tf.b, tf.prior_mean, tf.prior_inv_var,
                            u=tf.u, c0=tf.c0, ll_scale=tf.ll_scale, dtype=dtype, device="cpu")
    v, g = data.plain(torch.as_tensor(z))
    _close(v, v_p, TOL[dtype])
    _close(g, g_p, TOL[dtype])


def test_ar_family_is_the_model_density_up_to_a_constant():
    """The recognized family against autodiff of the port's own density."""
    _, tf, tc = _families(2)
    zs = torch.as_tensor(np.random.RandomState(4).normal(0, 0.4, size=(5, tc.dim)).astype(np.float32))
    g_ref, v_ref = torch.func.vmap(torch.func.grad_and_value(
        lambda zf: tc.log_density_z(tc.initial_params, tc.unravel_z(zf))))(zs)
    v, g = tf.plain(zs)
    dv = (v - v_ref).numpy()
    np.testing.assert_allclose(dv - dv[0], 0.0, atol=1e-5 * float(v_ref.abs().max()))
    _close(g, g_ref, 1e-5)


def test_masked_series_is_unrecognized_in_both():
    """With a log_prob_mask the family would count the missing rows, so the
    self-check against the autodiff density fails in both packages."""
    data = make_ar_data(200, (0.7,), 0.3, seed=0).copy()
    data[np.random.RandomState(1).choice(200, size=20, replace=False)] = np.nan
    comps = []
    for pkg, sp in ((BJ, JS), (BT, TS)):
        coeffs = pkg.NormalVariable(np.zeros(1, np.float32), 0.5 * np.ones(1, np.float32), "coeffs")
        noise = pkg.LogNormalVariable(-1.0, 0.5, "noise_scale")
        series = sp.ARProcess(200, coeffs, noise, name="series", order=1)
        sp.observe_timeseries(series, data)
        comps.append(pkg.ProbabilisticModel([series]))
    jc, tc = comps[0].compiled(), comps[1].compiled(device="cpu")
    assert PG.recognize_fused_family(jc, jc.initial_params) is None
    assert G.recognize_fused_family(tc, tc.initial_params) is None


def test_ar_sample_runs_the_fused_family_on_the_cpu():
    """sample() recognizes the AR model and its potential is the family's
    plain version (the kernels run only on CUDA tensors)."""
    from brancher_torch.inference import NUTS, sample

    data = make_ar_data(200, (0.7,), 0.3, seed=0)
    res = sample(t_ar_model(data, 1), kernel=NUTS(max_depth=6), num_samples=150,
                 num_warmup=150, num_chains=4, device="cpu", key=0)
    d = res.diagnostics
    assert d["fused_family"] == "normal_learned" and d["fused_dtype"] == "f32"
    c = float(res.samples["coeffs"].mean())
    s = float(res.samples["noise_scale"].mean())
    assert abs(c - 0.7) < 0.12 and abs(s - 0.3) < 0.05, (c, s)


@pytest.mark.slow
def test_ar1_nuts_posterior_matches_jax():
    """AR(1) under NUTS in both packages (the same data and sampler
    settings): posterior means within 5 MCSE of each other."""
    from brancher_torch.inference import NUTS as TNUTS, sample as t_sample
    from brancher_tpu.inference import NUTS as JNUTS, sample as j_sample
    import jax

    data = make_ar_data(length=400, coeffs=(0.7,), noise=0.3, seed=0)
    kw = dict(num_samples=500, num_warmup=400, num_chains=8)
    rj = j_sample(j_ar_model(data, 1), kernel=JNUTS(max_depth=8), key=jax.random.PRNGKey(0), **kw)
    rt = t_sample(t_ar_model(data, 1), kernel=TNUTS(max_depth=8), key=0, device="cpu", **kw)
    assert rt.diagnostics["fused_family"] == "normal_learned"
    for name in ("coeffs", "noise_scale"):
        xj = np.asarray(rj.samples[name], np.float64).reshape(8, 500, -1)
        xt = rt.samples[name].double().numpy().reshape(8, 500, -1)
        ej = np.ravel(rj.diagnostics["ess"][name])
        et = np.ravel(rt.diagnostics["ess"][name])
        mcse = np.sqrt(xj.var(axis=(0, 1)) / ej + xt.var(axis=(0, 1)) / et)
        z = np.abs(xj.mean(axis=(0, 1)) - xt.mean(axis=(0, 1))) / mcse
        assert float(z.max()) < 5.0, (name, z)
