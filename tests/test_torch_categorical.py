"""Port parity: the softmax family (brancher_torch.ops.glm's
categorical_vg_reference, CategoricalFusedFamily and the recognizer's
Categorical branch against brancher_tpu.ops.pallas_glm's), and sample()'s
choice to keep a softmax model on autodiff, as JAX does."""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu as BJ
import brancher_tpu.functions as BFJ
import brancher_tpu.inference as JI
import brancher_tpu.ops.pallas_glm as PG
import brancher_torch as BT
import brancher_torch.functions as BFT
import brancher_torch.ops.glm as G
from brancher_torch.bridge import CATEGORICAL_FIELDS, fused_family_from_numpy
from brancher_torch.inference import NUTS, sample

torch.set_num_threads(2)

# f32 products and softmax in two libraries: each value and gradient within
# 1e-5 of the larger of 1 and its largest magnitude
RTOL = 1e-5
N, DF, K = 60, 3, 4


def _close(got, ref, what="", rtol=RTOL):
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0, atol=rtol * scale,
                               err_msg=what)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, size=(N, DF)).astype(np.float32)
    w_true = rng.normal(0, 1.0, size=(DF, K)).astype(np.float32)
    y = np.argmax(x @ w_true + rng.gumbel(size=(N, K)), -1).astype(np.int32)
    return x, y


def _softmax(pkg, bf):
    """scripts/exp_categorical_speedup.py's model at a small width."""
    x, y = _data()
    w = pkg.NormalVariable(np.zeros((DF, K), np.float32), np.ones((DF, K), np.float32), "w")
    b = pkg.NormalVariable(np.zeros(K, np.float32), 2.0 * np.ones(K, np.float32), "b")
    yv = pkg.CategoricalVariable(logits=bf.matmul(x, w) + b, name="y")
    yv.observe(y)
    return pkg.ProbabilisticModel([yv])


def test_categorical_vg_reference_matches_jax():
    rng = np.random.RandomState(1)
    m, c, d = 5, 7, 11
    a = dict(x=rng.normal(size=(N, m)).astype(np.float32),
             y_onehot=np.eye(K, dtype=np.float32)[rng.randint(0, K, N)],
             c=rng.normal(0, 0.3, size=(N, K)).astype(np.float32),
             cols=rng.randint(0, m, d).astype(np.int32), ks=rng.randint(0, K, d).astype(np.int32),
             prior_mean=rng.normal(size=d).astype(np.float32),
             prior_inv_var=np.exp(rng.normal(size=d)).astype(np.float32))
    a["cols"][:2], a["ks"][:2] = 1, 2  # two coordinates in one cell: their sum enters
    z = rng.normal(0, 0.7, size=(c, d)).astype(np.float32)
    ref_v, ref_g = PG.categorical_vg_reference(jnp.asarray(z), **{k: jnp.asarray(v) for k, v in a.items()},
                                               ll_scale=1.3)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    t["cols"], t["ks"] = t["cols"].long(), t["ks"].long()
    v, g = G.categorical_vg_reference(torch.as_tensor(z), **t, ll_scale=1.3)
    _close(v.numpy(), ref_v, "val")
    _close(g.numpy(), ref_g, "grad")
    # and against autograd of the value
    zt = torch.as_tensor(z).requires_grad_(True)
    auto = torch.autograd.grad(G.categorical_vg_reference(zt, **t, ll_scale=1.3)[0].sum(), zt)[0]
    _close(g.numpy(), auto.numpy(), "grad vs autograd")


def test_recognizer_finds_the_same_structure_as_jax():
    jc, tc = _softmax(BJ, BFJ).compiled(), _softmax(BT, BFT).compiled("cpu")
    jf = PG.recognize_fused_family(jc, jc.initial_params)
    tf = G.recognize_fused_family(tc, tc.initial_params)
    assert isinstance(jf, PG.CategoricalFusedFamily) and isinstance(tf, G.CategoricalFusedFamily)
    assert tf.auto_upgradable is False and jf.auto_upgradable is False
    np.testing.assert_array_equal(tf.cols.numpy(), np.asarray(jf.cols))
    np.testing.assert_array_equal(tf.ks.numpy(), np.asarray(jf.ks))
    for field in ("x", "y_onehot", "c", "prior_mean", "prior_inv_var"):
        _close(getattr(tf, field).numpy(), np.asarray(getattr(jf, field)), field)
    assert tf.ll_scale == jf.ll_scale
    # the JAX family bridged into the port computes the port's function, and
    # both match autodiff of the compiled density up to its constant
    bridged = fused_family_from_numpy({k: np.asarray(getattr(jf, k)) for k in CATEGORICAL_FIELDS},
                                      device="cpu")
    zs = torch.as_tensor(np.random.RandomState(3).normal(size=(5, tc.dim)).astype(np.float32))
    v1, g1 = tf.value_and_grad()(zs)
    v2, g2 = bridged.value_and_grad()(zs)
    _close(v1.numpy(), v2.numpy())
    _close(g1.numpy(), g2.numpy())
    ref_v, ref_g = jax.vmap(jax.value_and_grad(
        lambda zf: jc.log_density_z(jc.initial_params,
                                    jax.flatten_util.ravel_pytree(jc.z_example())[1](zf))))(
        jnp.asarray(zs.numpy()))
    _close(g1.numpy(), ref_g, "grad vs JAX autodiff")
    dv = v1.numpy() - np.asarray(ref_v)
    np.testing.assert_allclose(dv - dv[0], 0.0, atol=1e-4)
    with pytest.raises(ValueError, match="bf16"):
        tf.value_and_grad(dtype="bf16")


def test_a_non_kronecker_map_is_not_the_family():
    """A coordinate feeding several classes has no (feature, class) cell."""
    def model(pkg, bf):
        x, y = _data()
        w = pkg.NormalVariable(np.zeros((DF, 1), np.float32), np.ones((DF, 1), np.float32), "w")
        yv = pkg.CategoricalVariable(logits=bf.matmul(x, w) * np.float32([1.0, 2.0, -1.0, 0.5]),
                                     name="y")
        yv.observe(y)
        return pkg.ProbabilisticModel([yv])

    jc, tc = model(BJ, BFJ).compiled(), model(BT, BFT).compiled("cpu")
    assert PG.recognize_fused_family(jc, jc.initial_params) is None
    assert G.recognize_fused_family(tc, tc.initial_params) is None


def test_sample_keeps_a_softmax_model_on_autodiff():
    model = _softmax(BT, BFT)
    kw = dict(kernel=NUTS(max_depth=4), num_samples=20, num_warmup=20, num_chains=4, device="cpu")
    res = sample(model, key=0, fused_potential="auto", **kw)
    comp = model.compiled("cpu")
    assert isinstance(comp._fused_family_cache, G.CategoricalFusedFamily)
    assert res.diagnostics["fused_family"] is None and res.diagnostics["fused_dtype"] is None
    assert res.diagnostics["value_and_grad_calls"] > 0
    # a bf16 request samples in f32 and warns, as JAX does
    with pytest.warns(UserWarning, match="bf16 fused potential is not in use"):
        res16 = sample(model, key=0, fused_potential="bf16", **kw)
    assert res16.diagnostics["fused_family"] is None
    for k in ("w", "b"):
        np.testing.assert_array_equal(res16.samples[k].numpy(), res.samples[k].numpy())


def _mean_sd_ess(x, ess):
    x = np.asarray(x, np.float64)
    return x.mean(axis=(0, 1)), x.std(axis=(0, 1)), np.asarray(ess, np.float64)


@pytest.mark.slow  # about 70 s on a CPU, JAX compiling its NUTS and both runs
def test_softmax_posterior_means_match_jax():
    kw = dict(num_samples=200, num_warmup=200, num_chains=8)
    jres = JI.sample(_softmax(BJ, BFJ), kernel=JI.NUTS(max_depth=6), key=jax.random.PRNGKey(0), **kw)
    tres = sample(_softmax(BT, BFT), kernel=NUTS(max_depth=6), key=1, device="cpu", **kw)
    for name in ("w", "b"):
        jm, jsd, jess = _mean_sd_ess(jres.samples[name], jres.diagnostics["ess"][name])
        tm, tsd, tess = _mean_sd_ess(tres.samples[name].numpy(), tres.diagnostics["ess"][name])
        mcse = np.sqrt(jsd**2 / jess + tsd**2 / tess)
        assert np.all(np.abs(tm - jm) < 5 * mcse), (name, np.abs(tm - jm) / mcse)
