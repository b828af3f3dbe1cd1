"""Port parity: SVI (brancher_torch.inference.svi against brancher_tpu's).

Torch and JAX draw different random numbers, so the ELBO is compared on
fixed draws: JAX computes its minibatch indices and guide noise from its
own keys, and the port is handed the same numbers (``draws=``).  Whole
runs that draw nothing (Taylor1, MAP) are compared step for step; runs
that do are compared with the closed form, with the tolerances of
``tests/test_inference_conjugate.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import brancher_tpu as BJ
import brancher_tpu.functions as BFJ
import brancher_tpu.inference.gradient_estimators as JE
import brancher_tpu.inference.guides as JG
import brancher_tpu.inference.svi as JS
import brancher_torch as BT
import brancher_torch.functions as BFT
import brancher_torch.inference.gradient_estimators as TE
import brancher_torch.inference.guides as TG
import brancher_torch.inference.svi as TS
from brancher_torch.bridge import params_to_torch
from brancher_torch.models import conjugate_normal_model, logistic_regression_model, make_logreg_data
from brancher_torch.optimizers import ProbabilisticOptimizer, resolve_optimizer

torch.set_num_threads(2)

N, B, D, S = 12, 5, 3, 4
# f32 sums in two libraries: each value and gradient within 1e-5 of its
# largest magnitude
RTOL = 1e-5


def _regression(pkg, bf):
    """A minibatched linear regression with a learnable offset: the loaders
    (idx, xb, yb), a Normal and a LogNormal latent, and a p param."""
    rng = np.random.RandomState(3)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = (x @ np.array([0.5, -1.0, 0.3], np.float32) + 0.2 * rng.normal(size=N)).astype(np.float32)
    idx = pkg.RandomIndices(N, B, "idx")
    xb = pkg.EmpiricalVariable(x, name="xb", indices=idx)
    yb = pkg.EmpiricalVariable(y, name="yb", indices=idx)
    w = pkg.NormalVariable(np.zeros(D, np.float32), np.ones(D, np.float32), "w")
    s = pkg.LogNormalVariable(0.0, 0.5, "s")
    b = pkg.DeterministicVariable(np.float32(0.3), "b", learnable=True)
    yv = pkg.NormalVariable(bf.matmul(xb, w) + b, s, "y", log_prob_scale=N / B)
    yv.observe(yb)
    return pkg.ProbabilisticModel([yv])


def _dsl_guide_model(pkg, bf):
    learn = lambda v, n: pkg.DeterministicVariable(np.asarray(v, np.float32), n, learnable=True)
    qw = pkg.NormalVariable(learn(np.full(D, 0.1), "qw_loc"), bf.exp(learn(np.full(D, -1.0), "qw_ls")), "w")
    qs = pkg.LogNormalVariable(learn(0.2, "qs_loc"), bf.exp(learn(-1.5, "qs_ls")), "s")
    return pkg.ProbabilisticModel([qw, qs])


GUIDES = ["AutoMeanField", "AutoFullRankNormal", "AutoIAF", "DSLGuide"]
ESTIMATORS = ["PathwiseDerivativeEstimator", "BlackBoxEstimator", "Taylor1Estimator"]


def _guides(name, jcomp, tcomp):
    if name == "DSLGuide":
        return (JG.DSLGuide(_dsl_guide_model(BJ, BFJ)),
                TG.DSLGuide(_dsl_guide_model(BT, BFT), device="cpu"))
    if name == "AutoIAF":
        return JG.AutoIAF(jcomp, num_flows=2, hidden=8), TG.AutoIAF(tcomp, num_flows=2, hidden=8)
    return getattr(JG, name)(jcomp), getattr(TG, name)(tcomp)


def _perturbed(tree, rng):
    """Every leaf moved by 0.1 N(0, 1), so that no gradient path is idle."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32), tree)


def _jax_draws(jcomp, jguide, jparams, key, n):
    """The numbers JAX's ReverseKL loss draws with ``key``, as numpy: the
    loaders' minibatch and the guide's standard-normal noise."""
    k_data, k_guide = jax.random.split(key)
    loaders = tuple(jcomp.data_loader_names)
    data = jcomp.sample_subgraph_one(jparams["p"], k_data, loaders) if loaders else {}
    keys = jax.random.split(k_guide, n)
    if isinstance(jguide, JG.DSLGuide):
        qc = jguide.comp
        noise = {v.name: np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(k, i), qc.shapes[v.name], jnp.float32)) for k in keys])
            for i, v in enumerate(qc.order) if isinstance(v, BJ.RandomVariable) and v.name not in data}
    else:
        noise = np.stack([np.asarray(jax.random.normal(k, (jguide.dim,))) for k in keys])
    return {k: np.asarray(v) for k, v in data.items()}, noise


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_close(got, ref, what):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale, err_msg=what)


def _elbo_and_grads_match(jmodel, tmodel, jguide_fn, n, seed, jparams_fn=None):
    """The port's loss and gradient at JAX's draws against JAX's."""
    jc, tc = jmodel.compiled(), tmodel.compiled("cpu")
    jguide, tguide, est_name = jguide_fn(jc, tc)
    jloss = JS.ReverseKL(getattr(JE, est_name)()).make_loss(jc, jguide)
    tloss = TS.ReverseKL(getattr(TE, est_name)()).make_loss(tc, tguide)
    key = jax.random.PRNGKey(seed)
    jparams = {"p": dict(jc.initial_params), "q": jguide.init_params(jax.random.PRNGKey(1))}
    if jparams_fn is not None:
        jparams = jparams_fn(jparams)
    ref_loss, ref_grad = jax.jit(jax.value_and_grad(jloss), static_argnums=2)(jparams, key, n)
    data, noise = _jax_draws(jc, jguide, jparams, key, n)
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    for _, leaf in _leaves(tparams):
        leaf.requires_grad_(True)
    draws = {"data": params_to_torch(data, device="cpu"),
             "noise": params_to_torch(noise, device="cpu") if isinstance(noise, dict)
             else torch.as_tensor(noise)}
    loss = tloss(tparams, None, n, draws=draws)
    _assert_close(loss.detach().numpy(), ref_loss, "loss")
    names, leaves = zip(*_leaves(tparams))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    ref = dict(_leaves(params_to_torch(jax.tree.map(np.asarray, ref_grad), device="cpu")))
    assert set(ref) == set(names)
    for name, g in zip(names, grads):
        _assert_close(g.numpy(), ref[name].numpy(), f"d loss / d {name}")


@pytest.mark.parametrize("est_name", ESTIMATORS)
@pytest.mark.parametrize("guide_name", GUIDES)
def test_fixed_draw_elbo_and_grads_match_jax(guide_name, est_name):
    rng = np.random.RandomState(7)

    def guides(jc, tc):
        return (*_guides(guide_name, jc, tc), est_name)

    if guide_name == "AutoIAF" and est_name == "BlackBoxEstimator":
        jc, tc = _regression(BJ, BFJ).compiled(), _regression(BT, BFT).compiled("cpu")
        jg, tg = _guides(guide_name, jc, tc)
        for loss in (JS.ReverseKL(JE.BlackBoxEstimator()).make_loss(jc, jg),):
            with pytest.raises(NotImplementedError, match="invertible"):
                loss({"p": jc.initial_params, "q": jg.init_params(jax.random.PRNGKey(1))},
                     jax.random.PRNGKey(0), S)
        tloss = TS.ReverseKL(TE.BlackBoxEstimator()).make_loss(tc, tg)
        with pytest.raises(NotImplementedError, match="invertible"):
            tloss({"p": tc.initial_params, "q": tg.init_params(torch.Generator().manual_seed(0))},
                  torch.Generator().manual_seed(0), S)
        return
    _elbo_and_grads_match(
        _regression(BJ, BFJ), _regression(BT, BFT), guides, S, seed=11,
        jparams_fn=lambda p: {"p": _perturbed(p["p"], rng), "q": _perturbed(p["q"], rng)})


def _conjugate(pkg):
    rng = np.random.RandomState(0)
    data = rng.normal(1.5, 1.0, size=20).astype(np.float32)
    mu = pkg.NormalVariable(0.0, 2.0, "mu")
    x = pkg.NormalVariable(mu, 1.0, "x")
    x.observe(data)
    return pkg.ProbabilisticModel([x])


def test_taylor1_run_matches_jax_step_for_step():
    """Taylor1 draws nothing: from JAX's initial guide params, 200 Adam
    steps give JAX's params within 1e-4."""
    jm, tm = _conjugate(BJ), _conjugate(BT)
    q0 = JG.AutoMeanField(jm.compiled()).init_params(jax.random.PRNGKey(5))
    q0 = {"loc": q0["loc"] + 0.3, "log_scale": q0["log_scale"]}
    jres = JS.perform_inference(jm, number_iterations=200, number_samples=2, lr=0.02,
                                inference_method=JS.ReverseKL(JE.Taylor1Estimator()),
                                key=jax.random.PRNGKey(0),
                                params_init={"q": q0})
    tres = TS.perform_inference(tm, number_iterations=200, number_samples=2, lr=0.02,
                                inference_method=TS.ReverseKL(TE.Taylor1Estimator()),
                                key=0, device="cpu",
                                params_init={"q": params_to_torch(jax.tree.map(np.asarray, q0),
                                                                  device="cpu")})
    for k in ("loc", "log_scale"):
        np.testing.assert_allclose(tres.params["q"][k].numpy(), np.asarray(jres.params["q"][k]),
                                   atol=1e-4)
    np.testing.assert_allclose(tres.loss_curve, jres.loss_curve, rtol=1e-4)


def test_map_run_matches_jax_step_for_step():
    jm, tm = _conjugate(BJ), _conjugate(BT)
    jres = JS.perform_inference(jm, number_iterations=200, lr=0.02, inference_method=JS.MAP(),
                                key=jax.random.PRNGKey(0))
    tres = TS.perform_inference(tm, number_iterations=200, lr=0.02, inference_method=TS.MAP(),
                                key=0, device="cpu")
    np.testing.assert_allclose(tres.params["z"]["mu"].numpy(), np.asarray(jres.params["z"]["mu"]),
                               atol=1e-4)
    np.testing.assert_allclose(float(tres.extras["map_point"]["mu"]),
                               float(jres.extras["map_point"]["mu"]), atol=1e-4)
    assert "q" not in tres.params and tres.guide is None


OPTIMIZERS = ["adam", "adamw", "sgd", "rmsprop", "adagrad"]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name):
    """20 steps on a fixed quadratic 0.5 (p - c)' A (p - c): each name takes
    optax's update rule (defaults differ for adamw, rmsprop, adagrad).  A is
    diagonal and no coordinate reaches c in 20 steps, so that the last
    bits of the two libraries' arithmetic are not amplified."""
    a = np.diag([0.5, 1.0, 2.0, 3.0]).astype(np.float32)
    c = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    p0 = np.array([-1.0, 0.5, 2.5, 1.0], np.float32)
    def loss(p, asarray):
        r = p - asarray(c)
        return 0.5 * r @ asarray(a) @ r

    tx = getattr(optax, name)(0.05)
    p, state, ref = jnp.asarray(p0), None, []
    state = tx.init(p)
    for _ in range(20):
        g = jax.grad(lambda q: loss(q, jnp.asarray))(p)
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
        ref.append(np.asarray(p))

    # optax computes Adam's bias corrections in f32 (1 - 0.999 is 5e-5 off
    # there), torch in float64: a step may differ by lr * 2.5e-5, so the
    # Adam rules are held to 20 such steps; the others to 1e-6
    atol = 20 * 0.05 * 2.5e-5 if name.startswith("adam") else 1e-6
    pt = torch.tensor(p0, requires_grad=True)
    opt = resolve_optimizer(name, 0.05)([pt])
    for step in range(20):
        opt.zero_grad()
        loss(pt, torch.as_tensor).backward()
        opt.step()
        np.testing.assert_allclose(pt.detach().numpy(), ref[step], rtol=0, atol=atol,
                                   err_msg=f"step {step}")


def test_optimizer_forms_and_probabilistic_optimizer():
    p = torch.zeros(2, requires_grad=True)
    assert isinstance(resolve_optimizer(torch.optim.SGD, 0.1)([p]), torch.optim.SGD)
    factory = lambda ps: torch.optim.SGD(ps, lr=0.5, momentum=0.9)
    assert resolve_optimizer(factory, 0.1)([p]).defaults["momentum"] == 0.9
    with pytest.raises(ValueError, match="unknown optimizer"):
        resolve_optimizer("lamb", 0.1)
    assert TS._resolve_optimizer is resolve_optimizer

    s = BT.DeterministicVariable(np.float32(2.0), "s", learnable=True)
    x = BT.NormalVariable(0.0, s, "x")
    x.observe(np.array([0.5, -0.5], np.float32))
    model = BT.ProbabilisticModel([x])
    opt = ProbabilisticOptimizer(model, "sgd", lr=0.1, device="cpu")
    comp = model.compiled("cpu")
    loss, params = opt.step(lambda ps: -comp.log_density_z(ps, {}))
    assert opt.parameter_names() == ["s"]
    # d(-log p)/ds = n/s - sum x^2/s^3 = 1 - 0.5/8
    assert float(params["s"].detach()) == pytest.approx(2.0 - 0.1 * (1.0 - 0.5 / 8.0), rel=1e-6)
    assert float(comp.initial_params["s"]) == 2.0  # the compiled params are not stepped


def test_svi_meanfield_matches_conjugate():
    """tests/test_inference_conjugate.py::test_svi_meanfield_matches_conjugate
    (its tolerances; 800 steps instead of 2000: Adam at lr 0.02 settles in
    about 200)."""
    model, info = conjugate_normal_model()
    res = TS.perform_inference(model, number_iterations=800, number_samples=32, lr=0.02,
                               key=0, device="cpu")
    loc, var = res.guide.posterior_moments(res.params["q"])
    assert abs(float(loc[0]) - info["post_mean"]) < 0.05
    assert abs(float(var[0]) - info["post_var"]) < 0.03
    assert res.loss_curve[-1] < res.loss_curve[0]
    np.testing.assert_array_equal(model.diagnostics["loss curve"], res.loss_curve)


def test_svi_blackbox_estimator():
    model, info = conjugate_normal_model()
    res = TS.perform_inference(model, number_iterations=1200, number_samples=64, lr=0.02, key=0,
                               device="cpu", inference_method=TS.ReverseKL(TE.BlackBoxEstimator()))
    loc, _ = res.guide.posterior_moments(res.params["q"])
    assert abs(float(loc[0]) - info["post_mean"]) < 0.15


def test_svi_dsl_guide():
    model, info = conjugate_normal_model()
    qloc = BT.DeterministicVariable(0.0, "qloc", learnable=True)
    qscale_raw = BT.DeterministicVariable(-1.0, "qscale_raw", learnable=True)
    q = BT.ProbabilisticModel([BT.NormalVariable(qloc, BFT.exp(qscale_raw), "mu")])
    model.set_posterior_model(q)
    res = TS.perform_inference(model, number_iterations=800, number_samples=32, lr=0.02, key=0,
                               device="cpu")
    qp = res.params["q"]
    assert abs(float(qp["qloc"]) - info["post_mean"]) < 0.05
    assert abs(float(torch.exp(2 * qp["qscale_raw"])) - info["post_var"]) < 0.05
    # the trained params went back onto the guide: posterior draws use them
    post = model.get_posterior_sample_dict(500, key=7, device="cpu")
    assert abs(float(post["mu"].mean()) - info["post_mean"]) < 0.1
    assert isinstance(res.guide, TG.DSLGuide) and res.guide.comp.initial_params is qp


def test_minibatch_scaling_is_unbiased():
    """tests/test_logreg_vae.py::test_minibatch_scaling_is_unbiased: the
    mean of the N/B-scaled minibatch likelihood is the full-data one."""
    x, y, _ = make_logreg_data(num_points=200, dim=4, seed=0)
    fcomp = logistic_regression_model(x, y).compiled("cpu")
    mcomp = logistic_regression_model(x, y, batch_size=50).compiled("cpu")
    w = 0.3 * torch.ones(4)
    lp_full = float(fcomp.log_likelihood_one(fcomp.initial_params, {"w": w}))
    loaders = tuple(mcomp.data_loader_names)
    assert loaders == ("idx", "xb", "yb")
    gen = torch.Generator().manual_seed(0)
    lps = [float(mcomp.log_likelihood_one(
        mcomp.initial_params, {"w": w, **mcomp.sample_subgraph_one(mcomp.initial_params, gen, loaders)}))
        for _ in range(400)]
    assert abs(np.mean(lps) - lp_full) < 0.02 * abs(lp_full)


def test_maximum_likelihood_uses_observed_data():
    """tests/test_logreg_vae.py::test_maximum_likelihood_uses_observed_data."""
    x, y, w_true = make_logreg_data(num_points=400, dim=6, seed=3)
    w = BT.DeterministicVariable(np.zeros(6, np.float32), "w", learnable=True)
    yv = BT.BernoulliVariable(logits=BFT.matmul(torch.as_tensor(x), w), name="y")
    yv.observe(y)
    res = TS.perform_inference(BT.ProbabilisticModel([yv]), number_iterations=600,
                               number_samples=1, lr=0.1, inference_method=TS.MaximumLikelihood(),
                               key=0, device="cpu")
    assert np.corrcoef(res.params["p"]["w"].numpy(), w_true)[0, 1] > 0.9


@pytest.mark.parametrize("kw", [{"mesh": object()}], ids=["mesh"])
def test_unported_options_raise_naming_the_roadmap(kw):
    """mesh= is ported (tests/test_torch_sharded_mcmc.py): a mesh that is
    not a DeviceMesh raises a TypeError naming it."""
    model, _ = conjugate_normal_model()
    with pytest.raises(TypeError, match="DeviceMesh"):
        TS.perform_inference(model, number_iterations=2, device="cpu", **kw)


def test_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, _ = conjugate_normal_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.perform_inference(model, number_iterations=2)


def test_benchmark_times_the_step_loop_and_guides_precedence():
    model, _ = conjugate_normal_model()
    TS.perform_inference._benchmark = True
    try:
        res = TS.perform_inference(model, number_iterations=5, number_samples=2, key=3, device="cpu")
        again = TS.perform_inference(model, number_iterations=5, number_samples=2, key=3, device="cpu")
    finally:
        TS.perform_inference._benchmark = False
    assert TS.perform_inference._last_run_seconds > 0
    np.testing.assert_array_equal(res.loss_curve, again.loss_curve)  # the same start each run
    assert isinstance(res.guide, TG.AutoMeanField)
    full = TG.AutoFullRankNormal(model.compiled("cpu"))
    assert TS.perform_inference(model, number_iterations=2, guide=full, device="cpu").guide is full


def test_dsl_guide_without_a_noise_form_walks_each_sample():
    """A guide variable with no noise form (a Bernoulli) cannot be drawn
    inside torch.func.vmap: the guide then walks each sample with the
    generator, and log q is still its log-joint of what it drew."""
    qloc = BT.DeterministicVariable(0.5, "qloc", learnable=True)
    q = BT.ProbabilisticModel([BT.NormalVariable(qloc, 1.0, "mu"),
                               BT.BernoulliVariable(logits=0.3, name="c")])
    guide = TG.DSLGuide(q, device="cpu")
    gen = torch.Generator().manual_seed(0)
    assert guide._noise(gen, 5, {}) is None
    params = guide.comp.initial_params
    values, logq = guide.sample_and_log_prob(params, gen, 5)
    assert values["mu"].shape == (5,) and values["c"].shape == (5,) and logq.shape == (5,)
    assert len(set(values["mu"].tolist())) == 5  # one draw a sample
    ref = guide.comp.log_prob(params, {"mu": values["mu"], "c": values["c"]})
    np.testing.assert_allclose(logq.numpy(), ref.numpy(), rtol=1e-6)
