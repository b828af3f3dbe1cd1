"""Port parity: normalizing flows (brancher_torch.transformations against
brancher_tpu's).  Each flow's forward, log-det and inverse with the same
parameters; a flow-transformed density; and a TransformedVariable guide's
ELBO and gradients at fixed draws (JAX's noise replayed, ``draws=``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu as BJ
import brancher_tpu.functions as BFJ
import brancher_tpu.inference.guides as JG
import brancher_tpu.inference.svi as JS
import brancher_tpu.transformations as JF
import brancher_torch as BT
import brancher_torch.functions as BFT
import brancher_torch.inference.guides as TG
import brancher_torch.inference.svi as TS
import brancher_torch.transformations as TF
from brancher_torch.bridge import params_to_torch

torch.set_num_threads(2)

# f32 sums in two libraries: each value and gradient within 1e-5 of the
# larger of 1 and its largest magnitude
RTOL = 1e-5
D = 3


def _close(got, ref, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0, atol=RTOL * scale,
                               err_msg=what)


def _params(name, rng):
    """JAX's initial parameters of a flow, moved by 0.3 N(0, 1)."""
    p = getattr(JF, name)().param_inits(D)
    return {k: np.asarray(v, np.float32) + 0.3 * rng.normal(size=np.shape(v)).astype(np.float32)
            for k, v in p.items()}


@pytest.mark.parametrize("name", ["PlanarFlow", "TriangularLinear", "Sigmoid", "Shift"])
def test_flow_forward_log_det_inverse_match_jax(name):
    rng = np.random.RandomState(2)
    jf, tf = getattr(JF, name)(), getattr(TF, name)()
    # the same initial parameters (PlanarFlow's from numpy's RandomState(0))
    for k, v in jf.param_inits(D).items():
        np.testing.assert_array_equal(tf.param_inits(D)[k].numpy(), np.asarray(v))
    params = _params(name, rng)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    z = rng.normal(size=D).astype(np.float32)
    x_ref, ld_ref = jf.forward_and_log_det(jnp.asarray(z), jp)
    x, ld = tf.forward_and_log_det(torch.as_tensor(z), tp)
    _close(x.numpy(), x_ref, "forward")
    _close(ld.numpy(), ld_ref, "log det")
    # the log-det is log|det| of the Jacobian (autograd, float64)
    tp64 = {k: v.double() for k, v in tp.items()}
    jac = torch.autograd.functional.jacobian(lambda v: tf.forward_and_log_det(v, tp64)[0],
                                             torch.as_tensor(z, dtype=torch.float64))
    np.testing.assert_allclose(float(ld), float(torch.linalg.slogdet(jac)[1]), atol=1e-5)
    assert tf.invertible == jf.invertible
    if tf.invertible:
        _close(tf.inverse(x, tp).numpy(), jf.inverse(x_ref, jp), "inverse")
        np.testing.assert_allclose(tf.inverse(x, tp).numpy(), z, atol=1e-5)


def _flows(mod):
    return [mod.TriangularLinear(), mod.Shift(), mod.Sigmoid()]


def test_transformed_density_matches_jax_and_the_sampling_direction():
    """An invertible stack: log_prob of a point equals JAX's, and equals the
    density accumulated along the draw that produced it."""
    rng = np.random.RandomState(3)
    jq = JF.TransformedVariable("z", dim=D, flows=_flows(JF))
    tq = TF.TransformedVariable("z", dim=D, flows=_flows(TF))
    jc, tc = BJ.ProbabilisticModel([jq]).compiled(), BT.ProbabilisticModel([tq]).compiled("cpu")
    assert sorted(tc.initial_params) == sorted(jc.initial_params)
    params = {k: np.asarray(v) + 0.2 * rng.normal(size=np.shape(v)).astype(np.float32)
              for k, v in jc.initial_params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = params_to_torch(params, device="cpu")
    eps = rng.normal(size=D).astype(np.float32)
    values, lp = tc._walk_sample(tc._as_store(tp), None, {}, {"z": torch.as_tensor(eps)})
    ref = jc.log_prob_one(jp, {"z": jnp.asarray(values["z"].numpy())})
    _close(tc.log_prob_one(tp, {"z": values["z"]}).numpy(), ref)
    _close(lp.numpy(), ref)


def test_triangular_linear_density_closed_form():
    """tests/test_transformations.py's check: a Gaussian through L z has the
    density of N(0, L L^T), to its 1e-4."""
    qz = TF.TransformedVariable("z", dim=2, flows=[TF.TriangularLinear()])
    comp = BT.ProbabilisticModel([qz]).compiled("cpu")
    params = dict(comp.initial_params)
    params["z__flow0_log_diag"] = torch.tensor([0.5, -0.3])
    params["z__flow0_tril"] = torch.tensor([[0.0, 0.0], [0.7, 0.0]])
    vals, lp = comp._walk_sample(comp._as_store(params), torch.Generator().manual_seed(0), {})
    z = vals["z"].numpy()
    L = np.array([[np.exp(0.5), 0.0], [0.7, np.exp(-0.3)]])
    cov = L @ L.T
    expect = -0.5 * z @ np.linalg.inv(cov) @ z - 0.5 * np.log(np.linalg.det(cov)) - np.log(2 * np.pi)
    np.testing.assert_allclose(float(lp), expect, rtol=1e-4)
    np.testing.assert_allclose(float(comp.log_prob_one(params, {"z": vals["z"]})), expect, rtol=1e-4)


def test_a_planar_stack_has_no_density_off_the_sampling_path():
    qz = TF.TransformedVariable("z", dim=2, flows=[TF.PlanarFlow()])
    comp = BT.ProbabilisticModel([qz]).compiled("cpu")
    with pytest.raises(NotImplementedError, match="non-invertible"):
        comp.log_prob_one(comp.initial_params, {"z": torch.zeros(2)})


def _regression(pkg, bf):
    rng = np.random.RandomState(4)
    x = rng.normal(size=(10, D)).astype(np.float32)
    y = (x @ np.float32([0.5, -1.0, 0.3]) + 0.3 * rng.normal(size=10)).astype(np.float32)
    w = pkg.NormalVariable(np.zeros(D, np.float32), np.ones(D, np.float32), "w")
    yv = pkg.NormalVariable(bf.matmul(x, w), 0.5, "y")
    yv.observe(y)
    return pkg.ProbabilisticModel([yv])


def test_flow_guide_elbo_and_grads_at_fixed_draws_match_jax():
    n = 4
    flows = lambda mod: [mod.TriangularLinear(), mod.Shift(), mod.PlanarFlow()]  # noqa: E731
    jc = _regression(BJ, BFJ).compiled()
    tc = _regression(BT, BFT).compiled("cpu")
    jguide = JG.DSLGuide(BJ.ProbabilisticModel([JF.TransformedVariable("w", D, flows(JF))]))
    tguide = TG.DSLGuide(BT.ProbabilisticModel([TF.TransformedVariable("w", D, flows(TF))]),
                         device="cpu")
    rng = np.random.RandomState(5)
    jparams = {"p": dict(jc.initial_params), "q": {
        k: np.asarray(v, np.float32) + 0.2 * rng.normal(size=np.shape(v)).astype(np.float32)
        for k, v in jguide.init_params(jax.random.PRNGKey(1)).items()}}
    key = jax.random.PRNGKey(9)
    jloss = JS.ReverseKL().make_loss(jc, jguide)
    ref_loss, ref_grad = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams), key, n)
    # JAX's guide noise: one key a sample, folded with the variable's place
    _, k_guide = jax.random.split(key)
    qc = jguide.comp
    i = next(i for i, v in enumerate(qc.order) if v.name == "w")
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, i), qc.shapes["w"]))
                      for k in jax.random.split(k_guide, n)])
    tparams = params_to_torch(jparams, device="cpu")
    leaves = {k: v.requires_grad_(True) for k, v in tparams["q"].items()}
    loss = TS.ReverseKL().make_loss(tc, tguide)(tparams, None, n,
                                                draws={"noise": {"w": torch.as_tensor(noise)}})
    _close(loss.detach().numpy(), ref_loss, "loss")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert set(leaves) == set(ref_grad["q"])
    for (name, _), g in zip(leaves.items(), grads):
        _close(g.numpy(), ref_grad["q"][name], f"d loss / d {name}")


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_flow_guide_trains_on_the_conjugate_model(device):
    """tests/test_transformations.py's flow-VI check and limits.  On a card
    the posterior draws read the trained guide: "cuda" and the compiled
    model's "cuda:0" are one cache key."""
    from brancher_torch.inference import perform_inference
    from brancher_torch.models import conjugate_normal_model

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, truth = conjugate_normal_model(num_obs=15)
    qmu = TF.TransformedVariable("mu", dim=1, flows=[TF.TriangularLinear(), TF.Shift()])
    model.set_posterior_model(BT.ProbabilisticModel([qmu]))
    perform_inference(model, number_iterations=1500, number_samples=16, lr=0.02, key=0,
                      device=device)
    post = model.get_posterior_sample_dict(2000, key=5, device=device)["mu"].double().cpu()
    assert abs(float(post.mean()) - truth["post_mean"]) < 0.1
    assert abs(float(post.var()) - truth["post_var"]) < 0.05


def test_a_bare_cuda_device_resolves_to_the_current_card(monkeypatch):
    """Every cache keyed by the device (a model's compiled cache, the guide's
    trained params on it) sees "cuda" and "cuda:0" as one device."""
    from brancher_torch.config import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device(None) == torch.device("cuda", 0)  # the default, config.device
    assert resolve_device("cpu") == torch.device("cpu")
