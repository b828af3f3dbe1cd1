"""Port parity: the compiled model (brancher_torch vs brancher_tpu).

The same models are built in both packages from the same numpy data; the
log-density and its gradient at shared random z must agree."""
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
from brancher_torch.compiler import CompiledModel
from brancher_tpu.models import conjugate_normal_model as j_conj
from brancher_tpu.models import logistic_regression_model as j_logreg
from brancher_tpu.models import make_logreg_data
from brancher_torch.models import conjugate_normal_model as t_conj
from brancher_torch.models import logistic_regression_model as t_logreg

torch.set_num_threads(2)


def _lognormal_scale_model(pkg, data):
    """x ~ N(mu, sigma), mu ~ N(0, 2), sigma ~ LogNormal(0, 0.5)."""
    mu = pkg.NormalVariable(0.0, 2.0, "mu")
    sigma = pkg.LogNormalVariable(0.0, 0.5, "sigma")
    x = pkg.NormalVariable(mu, sigma, "x")
    x.observe(data)
    return pkg.ProbabilisticModel([x])


def _models(name):
    if name == "conjugate":
        return j_conj()[0], t_conj()[0]
    if name == "logreg":
        x, y, _ = make_logreg_data(200, 5, seed=0)
        return j_logreg(x, y), t_logreg(x, y)
    data = np.random.RandomState(4).normal(1.0, 0.7, size=40).astype(np.float32)
    return _lognormal_scale_model(BJ, data), _lognormal_scale_model(BT, data)


@pytest.mark.parametrize("name", ["conjugate", "logreg", "lognormal_scale"])
def test_log_density_z_value_and_grad_match_jax(name):
    jm, tm = _models(name)
    jc, tc = jm.compiled(), tm.compiled(device="cpu")
    z0, unravel = jax.flatten_util.ravel_pytree(jc.z_example())
    assert tc.dim == z0.shape[0]
    zs = np.random.RandomState(1).normal(0, 0.8, size=(4, tc.dim)).astype(np.float32)

    def jpot(zf):
        return jc.log_density_z(jc.initial_params, unravel(zf))

    v_ref, g_ref = jax.vmap(jax.value_and_grad(jpot))(jnp.asarray(zs))
    g_t, v_t = torch.func.vmap(torch.func.grad_and_value(
        lambda zf: tc.log_density_z(tc.initial_params, tc.unravel_z(zf))))(torch.as_tensor(zs))
    # f32 sums over up to 200 terms in two libraries: relative 1e-5 of
    # the magnitude, plus an absolute floor for values near zero
    scale_v = float(np.max(np.abs(v_ref)))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-5 * scale_v)
    scale_g = float(np.max(np.abs(g_ref)))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-5 * scale_g)


def test_flat_layout_matches_ravel_pytree():
    """Two latents of different shapes, declared out of name order: the
    flat z must be ordered as ravel_pytree orders the dict (sorted)."""
    def build(pkg, zeros):
        b = pkg.NormalVariable(zeros(3), 1.0, "b_vec")
        a = pkg.LogNormalVariable(0.0, 1.0, "a_scale")
        y = pkg.NormalVariable(b.sum() * 0.1, a, "y")
        y.observe(np.array([0.3, -0.2], np.float32))
        return pkg.ProbabilisticModel([y])

    jc = build(BJ, jnp.zeros).compiled()
    tc = build(BT, torch.zeros).compiled(device="cpu")
    flat = np.arange(4, dtype=np.float32) + 1.0
    _, unravel = jax.flatten_util.ravel_pytree(jc.z_example())
    j_tree = unravel(jnp.asarray(flat))
    t_tree = tc.unravel_z(torch.as_tensor(flat))
    assert sorted(t_tree) == sorted(j_tree) == ["a_scale", "b_vec"]
    for k in j_tree:
        np.testing.assert_array_equal(t_tree[k].numpy(), np.asarray(j_tree[k]))
    np.testing.assert_array_equal(tc.ravel_z(t_tree).numpy(), flat)
    # and the batched form keeps the leading axis
    batch = torch.as_tensor(np.stack([flat, 2 * flat]))
    assert tc.unravel_z(batch)["b_vec"].shape == (2, 3)


def test_parts_and_observed_params_match_jax():
    data = np.random.RandomState(4).normal(1.0, 0.7, size=40).astype(np.float32)
    jc = _lognormal_scale_model(BJ, data).compiled()
    tc = _lognormal_scale_model(BT, data).compiled(device="cpu")
    z = {"mu": np.float32(0.4), "sigma": np.float32(-0.3)}
    jp = jc.log_density_z_parts(jc.initial_params, {k: jnp.asarray(v) for k, v in z.items()})
    tp = tc.log_density_z_parts(tc.initial_params, {k: torch.tensor(v) for k, v in z.items()})
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    jo = jc.eval_observed_params(jc.initial_params, {k: jnp.asarray(v) for k, v in z.items()})["x"]
    to = tc.eval_observed_params(tc.initial_params, {k: torch.tensor(v) for k, v in z.items()})["x"]
    np.testing.assert_allclose(float(to["loc"]), float(jo["loc"]), rtol=1e-6)
    np.testing.assert_allclose(float(to["scale"]), float(jo["scale"]), rtol=1e-6)


def test_constrain_unconstrain_roundtrip():
    data = np.random.RandomState(4).normal(1.0, 0.7, size=40).astype(np.float32)
    tc = _lognormal_scale_model(BT, data).compiled(device="cpu")
    z = {"mu": torch.tensor(0.4), "sigma": torch.tensor(-0.3)}
    vals = tc.constrain(tc.initial_params, z)
    assert float(vals["sigma"]) == pytest.approx(float(np.exp(-0.3)), rel=1e-6)
    assert vals["x"].shape == (40,)  # observed nodes come back too
    back = tc.unconstrain(tc.initial_params, {"mu": vals["mu"], "sigma": vals["sigma"]})
    for k in z:
        assert float(back[k]) == pytest.approx(float(z[k]), abs=1e-6)


def test_sample_one_and_z_example():
    x, y, _ = make_logreg_data(50, 4, seed=2)
    tc = t_logreg(x, y).compiled(device="cpu")
    assert tc.shapes["w"] == (4,) and tc.shapes["y"] == (50,)
    assert {k: tuple(v.shape) for k, v in tc.z_example().items()} == {"w": (4,)}
    draw = tc.sample_one(tc.initial_params, 5)
    assert draw["w"].shape == (4,)
    many = tc.sample(tc.initial_params, 1, 3)
    assert many["w"].shape == (3, 4) and many["y"].shape == (3, 50)
    assert torch.equal(tc.sample_one(tc.initial_params, 5)["w"], draw["w"])


def test_compiled_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = t_conj()[0]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.compiled()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledModel(model)  # the class itself defaults to config.device too
    assert model.compiled(device="cpu").device.type == "cpu"
    assert CompiledModel(model, device="cpu").device.type == "cpu"


def test_model_observe_by_name_matches_jax_and_recompiles():
    """ProbabilisticModel.observe({name: data}) conditions the model as in
    the JAX package; unobserve_all turns the variable back into a latent
    and the compiled model is rebuilt."""
    data = np.random.RandomState(6).normal(0.5, 1.0, size=7).astype(np.float32)

    def build(pkg):
        mu = pkg.NormalVariable(0.0, 2.0, "mu")
        x = pkg.NormalVariable(mu, 1.0, "x")
        model = pkg.ProbabilisticModel([x])
        model.observe({"x": data})
        return model, x

    (jm, _), (tm, tx) = build(BJ), build(BT)
    assert tx.observed_value is not None and tm.observed_variables == [tx]
    jc, tc = jm.compiled(), tm.compiled(device="cpu")
    z = np.float32(0.3)
    want = float(jc.log_density_z(jc.initial_params, {"mu": jnp.asarray(z)}))
    got = float(tc.log_density_z(tc.initial_params, {"mu": torch.tensor(z)}))
    # f32 sums of 8 terms in two libraries
    assert got == pytest.approx(want, rel=1e-6)
    tm.unobserve_all()
    assert tx.observed_value is None
    assert tm.compiled(device="cpu") is not tc
    assert tm.compiled(device="cpu").continuous_latent_names == ["mu", "x"]


def test_lifted_functions_build_expressions():
    w = BT.NormalVariable(torch.zeros(2), 1.0, "w")
    link = BFT.exp(w) + BFT.matmul(torch.eye(2), w)
    assert [v.name for v in link.vars] == ["w"]
    tc = BT.ProbabilisticModel([w]).compiled(device="cpu")
    val = link.fn({"w": torch.tensor([0.0, 1.0])}, tc._as_store(tc.initial_params))
    np.testing.assert_allclose(val.numpy(), [1.0, np.e + 1.0], rtol=1e-6)
    assert BFJ.exp is not None  # the JAX namespace exposes the same names


@pytest.mark.parametrize("name", ["conjugate", "logreg", "lognormal_scale"])
def test_log_prior_z_is_the_prior_part(name):
    _, tm = _models(name)
    tc = tm.compiled(device="cpu")
    for zf in torch.as_tensor(np.random.RandomState(2).normal(0, 0.8, size=(3, tc.dim)).astype(np.float32)):
        z = tc.unravel_z(zf)
        prior, _ = tc.log_density_z_parts(tc.initial_params, z)
        assert torch.equal(tc.log_prior_z(tc.initial_params, z), prior)


def test_log_prior_z_never_evaluates_the_likelihood(monkeypatch):
    """The recognizer's prior probe: an observed variable whose log_prob
    raises does not stop it (so a large likelihood is never computed)."""
    data = np.random.RandomState(4).normal(1.0, 0.7, size=40).astype(np.float32)
    tc = _lognormal_scale_model(BT, data).compiled(device="cpu")
    z = {"mu": torch.tensor(0.4), "sigma": torch.tensor(-0.3)}
    want = tc.log_density_z_parts(tc.initial_params, z)[0]
    obs = next(v for v in tc.order if v.name == "x")

    def refuse(*args, **kwargs):
        raise AssertionError("the likelihood was evaluated")

    monkeypatch.setattr(obs.distribution, "log_prob", refuse)
    assert torch.equal(tc.log_prior_z(tc.initial_params, z), want)
    with pytest.raises(AssertionError, match="likelihood was evaluated"):
        tc.log_density_z_parts(tc.initial_params, z)
