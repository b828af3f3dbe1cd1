"""Port parity: the distribution zoo (brancher_torch.distributions against
brancher_tpu's), event-valued plates, every variable constructor, and the
discrete-latent refusal of sample(), on shared numpy inputs."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import brancher_tpu as BJ
import brancher_tpu.distributions as JD
import brancher_tpu.standard_variables as JSV
import brancher_tpu.inference as JI
import brancher_torch as BT
import brancher_torch.distributions as TD
import brancher_torch.standard_variables as TSV
import brancher_torch.inference as TI

torch.set_num_threads(2)

# f32 elementwise math (lgamma, log1p, ndtr, a triangular solve) in two
# libraries: each log-density, mean and variance within 1e-5 of the
# larger of 1 and its largest magnitude
RTOL = 1e-5

_rng = np.random.RandomState(0)
_N = 32


def _pos(size=_N, s=0.5):
    return np.exp(_rng.normal(0, s, size=size)).astype(np.float32)


def _f(size=_N, s=1.0):
    return _rng.normal(0, s, size=size).astype(np.float32)


def _probs(size=_N):
    return _rng.uniform(0.05, 0.95, size=size).astype(np.float32)


_L = np.array([[1.2, 0.0, 0.0], [0.4, 0.8, 0.0], [-0.3, 0.5, 0.6]], np.float32)
_LOC3 = _f(3)
_VAL3 = _f((_N, 3))
_ALPHA = _pos(4) + 0.5
_SIMPLEX = _rng.dirichlet(np.ones(4), size=_N).astype(np.float32)
_LOGITS_K = _f((_N, 4), 2.0)
_LOW, _HIGH = np.float32(-1.0), np.float32(1.5)
_TN_VALUES = np.concatenate([_rng.uniform(-1.0, 1.5, _N - 4), [-1.5, 2.0, -1.0, 1.5]]).astype(np.float32)

CASES = {
    "halfnormal": (JD.HalfNormal(), TD.HalfNormal(), _pos(), {"scale": _pos()}),
    "cauchy": (JD.Cauchy(), TD.Cauchy(), _f(s=3), {"loc": _f(), "scale": _pos()}),
    "halfcauchy": (JD.HalfCauchy(), TD.HalfCauchy(), _pos(s=1), {"scale": _pos()}),
    "laplace": (JD.Laplace(), TD.Laplace(), _f(s=2), {"loc": _f(), "scale": _pos()}),
    "logistic": (JD.Logistic(), TD.Logistic(), _f(s=2), {"loc": _f(), "scale": _pos()}),
    "studentt": (JD.StudentT(), TD.StudentT(), _f(s=2),
                 {"df": _pos() * 4, "loc": _f(), "scale": _pos()}),
    "truncatednormal": (JD.TruncatedNormal(), TD.TruncatedNormal(), _TN_VALUES,
                        {"loc": _f(s=0.5), "scale": _pos(), "low": _LOW, "high": _HIGH}),
    "uniform": (JD.Uniform(), TD.Uniform(), _TN_VALUES, {"low": _LOW, "high": _HIGH}),
    "gamma": (JD.Gamma(), TD.Gamma(), _pos(), {"concentration": _pos() * 2, "rate": _pos()}),
    "inversegamma": (JD.InverseGamma(), TD.InverseGamma(), _pos(),
                     {"concentration": _pos() * 2, "scale": _pos()}),
    "exponential": (JD.Exponential(), TD.Exponential(), _pos(), {"rate": _pos()}),
    "chi2": (JD.Chi2(), TD.Chi2(), _pos(), {"df": _pos() * 3}),
    "beta": (JD.Beta(), TD.Beta(), _probs(), {"alpha": _pos() * 2, "beta": _pos() * 2}),
    "binomial_logits": (JD.Binomial(), TD.Binomial(), _rng.randint(0, 11, _N).astype(np.int32),
                        {"total_count": np.float32(10.0), "logits": _f()}),
    "binomial_probs": (JD.Binomial(), TD.Binomial(), _rng.randint(0, 21, _N).astype(np.int32),
                       {"total_count": np.float32(20.0), "probs": _probs()}),
    "poisson": (JD.Poisson(), TD.Poisson(), _rng.poisson(3.0, _N).astype(np.int32),
                {"rate": _pos() * 3}),
    "geometric_logits": (JD.Geometric(), TD.Geometric(), _rng.randint(0, 8, _N).astype(np.int32),
                         {"logits": _f()}),
    "geometric_probs": (JD.Geometric(), TD.Geometric(), _rng.randint(0, 8, _N).astype(np.int32),
                        {"probs": _probs()}),
    "categorical_logits": (JD.Categorical(), TD.Categorical(), _rng.randint(0, 4, _N).astype(np.int32),
                           {"logits": _LOGITS_K}),
    "categorical_probs": (JD.Categorical(), TD.Categorical(), _rng.randint(0, 4, _N).astype(np.int32),
                          {"probs": _SIMPLEX}),
    "concrete": (JD.Concrete(), TD.Concrete(), _SIMPLEX,
                 {"temperature": _pos(1)[0], "logits": _LOGITS_K}),
    # one value: the JAX MVN solves for a single sample (the compiler's unit)
    "mvn_scale_tril": (JD.MultivariateNormal(), TD.MultivariateNormal(), _VAL3[0],
                       {"loc": _LOC3, "scale_tril": _L}),
    "mvn_covariance": (JD.MultivariateNormal(), TD.MultivariateNormal(), _VAL3[1],
                       {"loc": _LOC3, "covariance_matrix": _L @ _L.T}),
    "dirichlet": (JD.Dirichlet(), TD.Dirichlet(), _SIMPLEX, {"concentration": _ALPHA}),
    "delta": (JD.Delta(), TD.Delta(), _f(), {"value": _f()}),
    "mixture_normal": (JD.Mixture(JD.Normal()), TD.Mixture(TD.Normal()), _f(s=2),
                       {"probs": np.float32([0.2, 0.5, 0.3]), "loc": _f(3), "scale": _pos(3)}),
    "mixture_logits_gamma": (JD.Mixture(JD.Gamma()), TD.Mixture(TD.Gamma()), _pos(),
                             {"logits": _f(2), "concentration": _pos(2) * 2, "rate": np.float32(1.5)}),
}


def _jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _torch(params):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    finite = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), finite), what
    np.testing.assert_array_equal(got[~finite], ref[~finite], err_msg=what)
    scale = max(1.0, float(np.max(np.abs(ref[finite])))) if finite.any() else 1.0
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_prob_matches_jax(case):
    jd, td, value, params = CASES[case]
    ref = jd.log_prob(jnp.asarray(value), **_jax(params))
    got = td.log_prob(torch.as_tensor(value), **_torch(params))
    _close(got.numpy(), ref, case)
    assert td.support == jd.support and td.event_ndim == jd.event_ndim
    assert td.is_discrete == jd.is_discrete and td.reparameterized == jd.reparameterized
    assert dict(td.param_event_ndims) == dict(jd.param_event_ndims)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mean_and_variance_match_jax_where_jax_has_them(case):
    jd, td, _, params = CASES[case]
    for method in ("mean", "variance"):
        try:
            ref = getattr(jd, method)(**_jax(params))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                getattr(td, method)(**_torch(params))
            continue
        _close(getattr(td, method)(**_torch(params)).numpy(), ref, f"{case}.{method}")


# every sampler against its known moments: 40000 draws, each mean within 5
# standard errors of the truth (and the variance within 5 of its own)
_S = 40000
MOMENTS = {
    "halfnormal": (TD.HalfNormal(), {"scale": 1.5}, 1.5 * math.sqrt(2 / math.pi), 2.25 * (1 - 2 / math.pi)),
    "laplace": (TD.Laplace(), {"loc": 0.5, "scale": 2.0}, 0.5, 8.0),
    "logistic": (TD.Logistic(), {"loc": -1.0, "scale": 0.7}, -1.0, math.pi**2 * 0.49 / 3),
    "studentt": (TD.StudentT(), {"df": 6.0, "loc": 1.0, "scale": 2.0}, 1.0, 4.0 * 6 / 4),
    "uniform": (TD.Uniform(), {"low": -1.0, "high": 3.0}, 1.0, 16 / 12),
    "gamma": (TD.Gamma(), {"concentration": 2.5, "rate": 1.5}, 2.5 / 1.5, 2.5 / 2.25),
    "inversegamma": (TD.InverseGamma(), {"concentration": 5.0, "scale": 2.0}, 0.5, 4 / (16 * 3)),
    "exponential": (TD.Exponential(), {"rate": 2.0}, 0.5, 0.25),
    "chi2": (TD.Chi2(), {"df": 3.0}, 3.0, 6.0),
    "beta": (TD.Beta(), {"alpha": 2.0, "beta": 3.0}, 0.4, 6 / (25 * 6)),
    "binomial": (TD.Binomial(), {"total_count": 12.0, "probs": 0.3}, 3.6, 12 * 0.21),
    "poisson": (TD.Poisson(), {"rate": 3.5}, 3.5, 3.5),
    "geometric": (TD.Geometric(), {"probs": 0.3}, 0.7 / 0.3, 0.7 / 0.09),
    "truncatednormal": (TD.TruncatedNormal(), {"loc": 0.3, "scale": 1.2, "low": -1.0, "high": 1.5},
                        scipy.stats.truncnorm((-1.0 - 0.3) / 1.2, (1.5 - 0.3) / 1.2, 0.3, 1.2).mean(),
                        scipy.stats.truncnorm((-1.0 - 0.3) / 1.2, (1.5 - 0.3) / 1.2, 0.3, 1.2).var()),
    "delta": (TD.Delta(), {"value": 2.5}, 2.5, 0.0),
}


@pytest.mark.parametrize("case", sorted(MOMENTS))
def test_sample_moments_within_mc_error(case):
    dist, params, mean, var = MOMENTS[case]
    g = torch.Generator().manual_seed(11)
    params = {k: torch.full((_S,), float(v)) for k, v in params.items()}
    x = dist.sample(g, **params).double()
    assert x.shape == (_S,)
    se = math.sqrt(var / _S) if var else 1e-12
    assert abs(float(x.mean()) - mean) < 5 * se + 1e-9, (float(x.mean()), mean)
    if var:
        # the variance's standard error from the sample's fourth moment
        se_var = math.sqrt(float(((x - x.mean()) ** 4).mean() - x.var() ** 2) / _S)
        assert abs(float(x.var()) - var) < 5 * se_var, (float(x.var()), var)


def test_heavy_tailed_and_vector_samplers():
    g = torch.Generator().manual_seed(12)
    # Cauchy and HalfCauchy: the quartiles (their means do not exist)
    c = TD.Cauchy().sample(g, loc=torch.full((_S,), 1.0), scale=torch.tensor(2.0)).numpy()
    q = np.quantile(c, [0.25, 0.75])
    np.testing.assert_allclose(q, [-1.0, 3.0], atol=0.1)  # se of a quartile ~0.03
    hc = TD.HalfCauchy().sample(g, scale=torch.full((_S,), 2.0)).numpy()
    assert hc.min() > 0 and abs(np.median(hc) - 2.0) < 0.1
    # Categorical frequencies, Dirichlet and Concrete on the simplex
    p = torch.tensor([0.1, 0.6, 0.3])
    k = TD.Categorical().sample(g, probs=p.expand(_S, 3))
    assert k.dtype == torch.int64
    freq = torch.bincount(k, minlength=3).double() / _S
    assert float((freq - p.double()).abs().max()) < 5 * math.sqrt(0.25 / _S)
    alpha = torch.tensor([1.0, 2.0, 3.0])
    dr = TD.Dirichlet().sample(g, concentration=alpha.expand(_S, 3)).double()
    np.testing.assert_allclose(dr.sum(-1).numpy(), 1.0, atol=1e-6)
    # Dirichlet(1, 2, 3): each mean's standard error below 0.19 / sqrt(S)
    np.testing.assert_allclose(dr.mean(0).numpy(), [1 / 6, 2 / 6, 3 / 6], atol=5 * 0.19 / math.sqrt(_S))
    cc = TD.Concrete().sample(g, temperature=torch.tensor(0.5), logits=torch.zeros(_S, 3))
    np.testing.assert_allclose(cc.sum(-1).numpy(), 1.0, atol=1e-5)
    # MVN: the mean and covariance of L eps
    L = torch.as_tensor(_L)
    m = TD.MultivariateNormal().sample(g, loc=torch.zeros(_S, 3), scale_tril=L).double()
    cov = np.cov(m.numpy().T)
    np.testing.assert_allclose(cov, _L @ _L.T, atol=0.05)  # se of a covariance entry ~0.01
    # a two-component mixture draws each component in proportion
    mix = TD.Mixture(TD.Normal())
    s = torch.stack([mix.sample(g, probs=torch.tensor([0.3, 0.7]), loc=torch.tensor([-2.0, 2.0]),
                                scale=torch.tensor(0.3)) for _ in range(4000)])
    assert abs(float((s > 0).double().mean()) - 0.7) < 0.03  # tests/test_mixture.py's limit


def test_mixture_log_prob_closed_form():
    """tests/test_mixture.py's closed form, to its 1e-4."""
    lp = float(TD.Mixture(TD.Normal()).log_prob(
        torch.tensor(0.5), probs=torch.tensor([0.3, 0.7]), loc=torch.tensor([-2.0, 2.0]),
        scale=torch.tensor([0.5, 0.5])))
    npdf = lambda v, mu, s: np.exp(-0.5 * ((v - mu) / s) ** 2) / (s * np.sqrt(2 * np.pi))  # noqa: E731
    np.testing.assert_allclose(lp, np.log(0.3 * npdf(0.5, -2, 0.5) + 0.7 * npdf(0.5, 2, 0.5)), rtol=1e-4)


def test_mvn_covariance_and_scale_tril_agree():
    v, loc = torch.as_tensor(_VAL3), torch.as_tensor(_LOC3)
    a = TD.MultivariateNormal().log_prob(v, loc=loc, scale_tril=torch.as_tensor(_L))
    b = TD.MultivariateNormal().log_prob(v, loc=loc, covariance_matrix=torch.as_tensor(_L @ _L.T))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    ref = scipy.stats.multivariate_normal(_LOC3, _L @ _L.T).logpdf(_VAL3)
    np.testing.assert_allclose(a.numpy(), ref, rtol=1e-5)
    with pytest.raises(ValueError, match="exactly one"):
        TD.MultivariateNormal().log_prob(v, loc=loc)


def test_constructors_match_jax():
    assert set(TSV.__all__) == set(JSV.__all__)
    assert set(TD.DISTRIBUTIONS) == set(JD.DISTRIBUTIONS)


def _zoo_model(pkg):
    """A model over every continuous support: its z-space density holds
    the transforms' log-dets (Sigmoid, Interval, StickBreaking, Exp)."""
    a = pkg.BetaVariable(2.0, 3.0, "a")
    u = pkg.UniformVariable(-1.0, 2.0, "u")
    t = pkg.TruncatedNormalVariable(0.3, 1.2, -1.0, 1.5, "t")
    s = pkg.DirichletVariable(np.float32([1.0, 2.0, 3.0]), "s")
    g = pkg.GammaVariable(2.0, 1.5, "g")
    ig = pkg.InverseGammaVariable(3.0, 2.0, "ig")
    e = pkg.ExponentialVariable(2.0, "e")
    h = pkg.HalfNormalVariable(1.0, "h")
    hc = pkg.HalfCauchyVariable(1.0, "hc")
    c2 = pkg.Chi2Variable(3.0, "c2")
    st = pkg.StudentTVariable(5.0, 0.0, 1.0, "st")
    la = pkg.LaplaceVariable(0.0, 1.0, "la")
    lo = pkg.LogisticVariable(0.0, 1.0, "lo")
    ca = pkg.CauchyVariable(0.0, 1.0, "ca")
    mv = pkg.MultivariateNormalVariable(np.zeros(3, np.float32), "mv", scale_tril=_L)
    loc = a + u + t + g + ig + e + h + hc + c2 + st + la + lo + ca
    y = pkg.NormalVariable(loc, 2.0, "y")
    y.observe(np.float32(1.0))
    w = pkg.NormalVariable(mv, 1.0, "w")
    w.observe(np.float32([0.1, -0.2, 0.3]))
    k = pkg.CategoricalVariable(probs=s, name="k")
    k.observe(np.int32(2))
    return pkg.ProbabilisticModel([y, w, k])


def test_every_support_in_the_compiled_density_matches_jax():
    jc = _zoo_model(BJ).compiled()
    tc = _zoo_model(BT).compiled("cpu")
    assert tc.z_shapes == {k: tuple(v) for k, v in jc.z_shapes.items()}
    z = {n: np.random.RandomState(4).normal(0, 0.7, size=s).astype(np.float32)
         for n, s in jc.z_shapes.items()}
    ref, ref_g = jax.value_and_grad(lambda zz: jc.log_density_z(jc.initial_params, zz))(
        {k: jnp.asarray(v) for k, v in z.items()})
    zt = {k: torch.as_tensor(v).requires_grad_(True) for k, v in z.items()}
    got = tc.log_density_z(tc.initial_params, zt)
    _close(got.detach().numpy(), ref)
    grads = torch.autograd.grad(got, list(zt.values()))
    for (name, _), gr in zip(zt.items(), grads):
        _close(gr.numpy(), ref_g[name], name)
    # constrain / unconstrain round trip through every transform
    vals = tc.constrain(tc.initial_params, {k: v.detach() for k, v in zt.items()})
    back = tc.unconstrain(tc.initial_params, {k: vals[k] for k in z})
    for k in z:
        np.testing.assert_allclose(back[k].numpy(), z[k], atol=2e-4, err_msg=k)


def _plated(pkg):
    m = pkg.MultivariateNormalVariable(np.zeros(3, np.float32), "m", scale_tril=_L, plate_shape=(4,))
    d = pkg.DirichletVariable(np.float32([1.0, 2.0, 3.0]), "d", plate_shape=(2,))
    y = pkg.NormalVariable(pkg.DeterministicVariable(m, "m_copy") * 1.0, 1.0, "y")
    y.observe(np.zeros((4, 3), np.float32))
    return pkg.ProbabilisticModel([y, d])


def test_event_valued_plates_match_jax():
    jc, tc = _plated(BJ).compiled(), _plated(BT).compiled("cpu")
    for name, shape in (("m", (4, 3)), ("d", (2, 3))):
        assert tc.shapes[name] == tuple(jc.shapes[name]) == shape
    assert tc.z_shapes == {k: tuple(v) for k, v in jc.z_shapes.items()}
    rng = np.random.RandomState(5)
    vals = {"m": rng.normal(size=(4, 3)).astype(np.float32),
            "d": rng.dirichlet(np.ones(3), size=2).astype(np.float32)}
    ref = jc.log_prob_one(jc.initial_params, {k: jnp.asarray(v) for k, v in vals.items()})
    got = tc.log_prob_one(tc.initial_params, {k: torch.as_tensor(v) for k, v in vals.items()})
    _close(got.numpy(), ref)
    draws = _plated(BT).get_sample_dict(3, key=0, device="cpu")
    assert draws["m"].shape == (3, 4, 3) and draws["d"].shape == (3, 2, 3)
    np.testing.assert_allclose(draws["d"].sum(-1).numpy(), 1.0, atol=1e-5)


def _discrete_latent(pkg):
    zb = pkg.BernoulliVariable(0.5, "zb")
    mu = pkg.NormalVariable(0.0, 1.0, "mu")
    y = pkg.NormalVariable(mu + zb, 1.0, "y")
    y.observe(np.float32(0.3))
    return pkg.ProbabilisticModel([y])


def test_a_discrete_latent_into_sample_raises_in_both_packages():
    with pytest.raises(ValueError, match="discrete latent 'zb' must be provided via `given`"):
        JI.sample(_discrete_latent(BJ), num_samples=5, num_warmup=5, num_chains=2,
                  key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="discrete latent 'zb' must be provided via `given`"):
        TI.sample(_discrete_latent(BT), num_samples=5, num_warmup=5, num_chains=2, device="cpu")
