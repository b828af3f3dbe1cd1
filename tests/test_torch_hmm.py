"""Port parity: the HMMs of stochastic_processes (brancher_torch against
brancher_tpu).

``GaussianHMM`` and ``EmissionHMM`` log-densities (the forward algorithm)
are held to JAX's and to brute force over every state path within
1e-4 * max(1, |value|); forward-backward marginals within 1e-5; Viterbi
paths must be identical to JAX's and to the brute-force argmax.  Draws
come from a torch.Generator (JAX splits keys), so they are held to the
chain's own statistics.  The model-level tests put priors on the
emissions and hold ``log_density_z`` and its gradient to JAX's; the
whole NUTS runs of JAX's tests are marked slow, as there."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import poisson as sp_poisson

import brancher_torch as BT
import brancher_torch.stochastic_processes as TSP
import brancher_tpu as BJ
import brancher_tpu.stochastic_processes as JSP
from brancher_torch.distributions import Normal as TNormal, Poisson as TPoisson
from brancher_torch.inference import NUTS, sample
from brancher_tpu.distributions import Normal as JNormal, Poisson as JPoisson

torch.set_num_threads(2)
TOL = 1e-4
TOL_PROB = 1e-5

TRANS = np.asarray([[0.9, 0.1], [0.2, 0.8]], np.float32)
PARAMS = dict(init_logits=np.log(np.asarray([0.6, 0.4], np.float32)),
              trans_logits=np.log(TRANS), locs=np.asarray([-2.0, 2.0], np.float32),
              scales=np.asarray([0.7, 0.7], np.float32))
POISSON_TRANS = np.asarray([[0.92, 0.08], [0.15, 0.85]], np.float32)


def _gen(t=60, seed=0):
    rng = np.random.RandomState(seed)
    s = rng.choice(2, p=[0.6, 0.4])
    states, ys = [], []
    for _ in range(t):
        states.append(s)
        ys.append(PARAMS["locs"][s] + 0.7 * rng.randn())
        s = rng.choice(2, p=TRANS[s])
    return np.asarray(ys, np.float32), np.asarray(states)


def _gen_poisson(t=100, seed=4, rates=(1.0, 8.0)):
    rng = np.random.RandomState(seed)
    s, states, ys = 0, [], []
    for _ in range(t):
        states.append(s)
        ys.append(rng.poisson(rates[s]))
        s = rng.choice(2, p=POISSON_TRANS[s])
    return np.asarray(ys, np.float32), np.asarray(states)


def _poisson_params():
    return dict(init_logits=np.zeros(2, np.float32), trans_logits=np.log(POISSON_TRANS),
                emission_rate=np.asarray([1.0, 8.0], np.float32))


def _t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def _paths_log_joint(ys, log_init, log_trans, emis):
    """{path: log p(path, ys)} over every state path (emis(t, s))."""
    t_len, k = len(ys), log_init.shape[0]
    out = {}
    for path in itertools.product(range(k), repeat=t_len):
        lp = log_init[path[0]] + emis(0, path[0])
        for t in range(1, t_len):
            lp += log_trans[path[t - 1], path[t]] + emis(t, path[t])
        out[path] = lp
    return out


def _gauss_emis(ys):
    locs, scales = PARAMS["locs"], PARAMS["scales"]
    return lambda t, s: (-0.5 * ((ys[t] - locs[s]) / scales[s]) ** 2 - np.log(scales[s])
                         - 0.5 * np.log(2 * np.pi))


def _log_softmax(x):
    x = np.asarray(x, np.float64)
    return x - np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1, keepdims=True)) - x.max(-1, keepdims=True)


def test_gaussian_hmm_log_prob_matches_jax_and_bruteforce():
    ys, _ = _gen(t=8)
    got = float(TSP.GaussianHMM(8).log_prob(torch.as_tensor(ys), **_t(PARAMS)))
    _close(got, float(JSP.GaussianHMM(8).log_prob(jnp.asarray(ys), **_j(PARAMS))), TOL)
    joint = _paths_log_joint(ys, _log_softmax(PARAMS["init_logits"]),
                             _log_softmax(PARAMS["trans_logits"]), _gauss_emis(ys))
    _close(got, np.logaddexp.reduce(list(joint.values())), TOL, "brute force")


def test_gaussian_hmm_batched_series_match_one_by_one():
    """Leading axes ride along the recursion: a [B, T] batch of series and
    of parameters gives each series' own log-density."""
    ys = np.stack([_gen(t=10, seed=s)[0] for s in range(3)])
    params = {k: np.stack([v] * 3) for k, v in PARAMS.items()}
    params["locs"] = params["locs"] + np.asarray([[0.0], [0.3], [-0.2]], np.float32)
    hmm = TSP.GaussianHMM(10)
    batched = hmm.log_prob(torch.as_tensor(ys), **_t(params))
    one = [float(hmm.log_prob(torch.as_tensor(ys[b]), **{k: torch.as_tensor(v[b])
                                                        for k, v in params.items()}))
           for b in range(3)]
    _close(batched.numpy(), one, TOL_PROB)
    post = hmm.posterior_marginals(torch.as_tensor(ys), **_t(params))
    assert post.shape == (3, 10, 2)
    assert hmm.viterbi(torch.as_tensor(ys), **_t(params)).shape == (3, 10)


def test_posterior_marginals_match_jax():
    ys, states = _gen(t=20, seed=2)
    want = np.asarray(JSP.hmm_posterior_marginals(jnp.asarray(ys), **_j(PARAMS)))
    got = TSP.hmm_posterior_marginals(ys, **PARAMS)
    assert got.shape == (20, 2)
    _close(got.numpy(), want, TOL_PROB, "hmm_posterior_marginals")
    _close(TSP.GaussianHMM(20).posterior_marginals(torch.as_tensor(ys), **_t(PARAMS)).numpy(),
           want, TOL_PROB, "GaussianHMM.posterior_marginals")
    em = dict(init_logits=PARAMS["init_logits"], trans_logits=PARAMS["trans_logits"],
              emission_loc=PARAMS["locs"], emission_scale=PARAMS["scales"])
    want_em = np.asarray(JSP.EmissionHMM(20, JNormal()).posterior_marginals(jnp.asarray(ys), **_j(em)))
    got_em = TSP.EmissionHMM(20, TNormal()).posterior_marginals(torch.as_tensor(ys), **_t(em))
    _close(got_em.numpy(), want_em, TOL_PROB, "EmissionHMM.posterior_marginals")
    assert (got.numpy().argmax(-1) == states).mean() > 0.8


def test_posterior_marginals_match_bruteforce():
    ys, _ = _gen(t=7, seed=5)
    joint = _paths_log_joint(ys, _log_softmax(PARAMS["init_logits"]),
                             _log_softmax(PARAMS["trans_logits"]), _gauss_emis(ys))
    lz = np.logaddexp.reduce(list(joint.values()))
    want = np.zeros((7, 2))
    for path, lp in joint.items():
        for t, s in enumerate(path):
            want[t, s] += np.exp(lp - lz)
    _close(TSP.hmm_posterior_marginals(ys, **PARAMS).numpy(), want, TOL_PROB)


def test_emission_hmm_matches_gaussian_and_jax():
    ys, _ = _gen(t=40, seed=3)
    em = dict(init_logits=PARAMS["init_logits"], trans_logits=PARAMS["trans_logits"],
              emission_loc=PARAMS["locs"], emission_scale=PARAMS["scales"])
    got = float(TSP.EmissionHMM(40, TNormal()).log_prob(torch.as_tensor(ys), **_t(em)))
    _close(got, float(TSP.GaussianHMM(40).log_prob(torch.as_tensor(ys), **_t(PARAMS))), TOL)
    _close(got, float(JSP.EmissionHMM(40, JNormal()).log_prob(jnp.asarray(ys), **_j(em))), TOL)


def test_poisson_emission_hmm_matches_jax_and_bruteforce():
    ys, _ = _gen_poisson(t=8)
    p = _poisson_params()
    got = float(TSP.EmissionHMM(8, TPoisson()).log_prob(torch.as_tensor(ys), **_t(p)))
    _close(got, float(JSP.EmissionHMM(8, JPoisson()).log_prob(jnp.asarray(ys), **_j(p))), TOL)
    rates = p["emission_rate"]
    joint = _paths_log_joint(ys, _log_softmax(p["init_logits"]), _log_softmax(p["trans_logits"]),
                             lambda t, s: sp_poisson.logpmf(ys[t], rates[s]))
    _close(got, np.logaddexp.reduce(list(joint.values())), TOL, "brute force")


@pytest.mark.parametrize("family", ["gaussian", "poisson"])
def test_viterbi_matches_jax_and_bruteforce(family):
    """The decoded path is JAX's and the brute-force argmax, exactly."""
    if family == "gaussian":
        ys, states = _gen(t=8, seed=2)
        p = dict(init_logits=PARAMS["init_logits"], trans_logits=PARAMS["trans_logits"],
                 emission_loc=PARAMS["locs"], emission_scale=PARAMS["scales"])
        t_hmm, j_hmm = TSP.EmissionHMM(8, TNormal()), JSP.EmissionHMM(8, JNormal())
        emis = _gauss_emis(ys)
        g_path = TSP.GaussianHMM(8).viterbi(torch.as_tensor(ys), **_t(PARAMS))
    else:
        ys, states = _gen_poisson(t=8, seed=6)
        p = _poisson_params()
        t_hmm, j_hmm = TSP.EmissionHMM(8, TPoisson()), JSP.EmissionHMM(8, JPoisson())
        emis = lambda t, s: sp_poisson.logpmf(ys[t], p["emission_rate"][s])  # noqa: E731
        g_path = None
    path = t_hmm.viterbi(torch.as_tensor(ys), **_t(p)).tolist()
    assert path == np.asarray(j_hmm.viterbi(jnp.asarray(ys), **_j(p))).tolist()
    joint = _paths_log_joint(ys, _log_softmax(p["init_logits"]), _log_softmax(p["trans_logits"]),
                             emis)
    assert tuple(path) == max(joint, key=joint.get)
    if g_path is not None:
        assert g_path.tolist() == path
        assert (np.asarray(path) == states).mean() >= 0.75


def test_viterbi_and_marginals_at_length_match_jax():
    ys, states = _gen_poisson(t=150, seed=6)
    p = _poisson_params()
    t_hmm, j_hmm = TSP.EmissionHMM(150, TPoisson()), JSP.EmissionHMM(150, JPoisson())
    post = t_hmm.posterior_marginals(torch.as_tensor(ys), **_t(p))
    _close(post.numpy(), np.asarray(j_hmm.posterior_marginals(jnp.asarray(ys), **_j(p))), TOL_PROB)
    assert (post.numpy().argmax(-1) == states).mean() > 0.85
    assert (t_hmm.viterbi(torch.as_tensor(ys), **_t(p)).tolist()
            == np.asarray(j_hmm.viterbi(jnp.asarray(ys), **_j(p))).tolist())


def test_means_match_jax():
    _close(TSP.GaussianHMM(5).mean(**_t(PARAMS)).numpy(),
           np.asarray(JSP.GaussianHMM(5).mean(**_j(PARAMS))), TOL_PROB)
    em = TSP.EmissionHMM(5, TNormal()).mean(
        init_logits=torch.as_tensor(PARAMS["init_logits"]),
        trans_logits=torch.as_tensor(PARAMS["trans_logits"]),
        emission_loc=torch.as_tensor(PARAMS["locs"]), emission_scale=torch.as_tensor(PARAMS["scales"]))
    _close(em.numpy(), np.asarray(JSP.GaussianHMM(5).mean(**_j(PARAMS))), TOL_PROB)


def test_draws_follow_the_chain():
    """4000 series of length 6 at tiny emission scales: the states read off
    the draws have the chain's initial and transition frequencies (within
    5 standard errors), and the Poisson draws are non-negative counts."""
    gen = torch.Generator().manual_seed(0)
    b = 4000
    params = {k: torch.as_tensor(v).expand((b,) + v.shape) for k, v in PARAMS.items()}
    params["scales"] = torch.full((b, 2), 1e-3)
    ys = TSP.GaussianHMM(6).sample(gen, **params)
    assert ys.shape == (b, 6)
    s = (ys > 0).long().numpy()
    p0 = np.exp(_log_softmax(PARAMS["init_logits"]))
    assert abs(s[:, 0].mean() - p0[1]) < 5 * np.sqrt(p0[1] * p0[0] / b)
    for j in range(2):
        prev = s[:, :-1] == j
        frac = (s[:, 1:][prev] == 1).mean()
        se = np.sqrt(TRANS[j, 1] * TRANS[j, 0] / prev.sum())
        assert abs(frac - TRANS[j, 1]) < 5 * se, (j, frac)
    draw = TSP.EmissionHMM(150, TPoisson()).sample(gen, **_t(_poisson_params()))
    assert draw.shape == (150,) and bool(torch.all(draw >= 0))


def test_emission_hmm_param_validation():
    with pytest.raises(ValueError) as e:
        TSP.EmissionHMMVariable(10, TPoisson(), init_logits=np.zeros(2, np.float32),
                                trans_logits=np.zeros((2, 2), np.float32), wrong_name=1.0, name="y")
    assert "rate" in str(e.value) and "wrong_name" in str(e.value)


def _hmm_model(pkg, ys):
    P, SP = (BJ, JSP) if pkg == "jax" else (BT, TSP)
    locs = P.NormalVariable(np.zeros(2, np.float32), 5.0 * np.ones(2, np.float32), "locs")
    series = SP.HMMVariable(len(ys), init_logits=np.zeros(2, np.float32),
                            trans_logits=np.log(TRANS), locs=locs,
                            scales=np.asarray([0.7, 0.7], np.float32), name="y")
    series.observe(ys)
    return P.ProbabilisticModel([series])


def _poisson_model(pkg, ys):
    P, SP, Pois = (BJ, JSP, JPoisson) if pkg == "jax" else (BT, TSP, TPoisson)
    rates = P.LogNormalVariable(np.zeros(2, np.float32), 2.0 * np.ones(2, np.float32), "rates")
    series = SP.EmissionHMMVariable(len(ys), Pois(), init_logits=np.zeros(2, np.float32),
                                    trans_logits=np.log(POISSON_TRANS), rate=rates, name="y")
    series.observe(ys)
    return P.ProbabilisticModel([series])


@pytest.mark.parametrize("make,data", [(_hmm_model, _gen(t=20, seed=1)[0]),
                                       (_poisson_model, _gen_poisson(t=20, seed=5)[0])],
                         ids=["gaussian", "poisson"])
def test_hmm_variable_density_z_matches_jax(make, data):
    """The compiled HMM variable under priors: log_density_z and its
    gradient (what NUTS differentiates) at random z, as JAX's."""
    jc, tc = make("jax", data).compiled(), make("torch", data).compiled("cpu")
    assert tc.discrete_latent_names == [] and tc.dim == 2
    rng = np.random.RandomState(0)
    for _ in range(3):
        z = {n: rng.normal(0, 0.7, s).astype(np.float32) for n, s in tc.z_shapes.items()}
        v_j, g_j = jax.value_and_grad(lambda zz: jc.log_density_z(jc.initial_params, zz))(_j(z))
        zt = {k: torch.tensor(v, requires_grad=True) for k, v in z.items()}
        v_t = tc.log_density_z(tc.initial_params, zt)
        (g_t,) = torch.autograd.grad(v_t, list(zt.values()))
        _close(float(v_t.detach()), float(v_j), TOL)
        _close(g_t.numpy(), np.asarray(next(iter(g_j.values()))), TOL)


def test_hmm_names_are_exported():
    for name in ("HMMVariable", "EmissionHMMVariable", "compile_model"):
        assert hasattr(BT, name)
    for name in ("GaussianHMM", "EmissionHMM", "EmissionHMMVariable", "hmm_posterior_marginals",
                 "HMMVariable"):
        assert name in TSP.__all__
    comp = BT.compile_model(_hmm_model("torch", _gen(t=5)[0]), device="cpu")
    assert isinstance(comp, BT.CompiledModel) and comp.device.type == "cpu"


@pytest.mark.slow
def test_hmm_nuts_recovers_emission_means():
    """JAX's test_hmm_nuts_recovers_emission_means on the port (T=120,
    NUTS(max_depth=7), 4 chains, 400 + 400), with its limits."""
    ys, _ = _gen(t=120, seed=1)
    res = sample(_hmm_model("torch", ys), kernel=NUTS(max_depth=7), num_samples=400,
                 num_warmup=400, num_chains=4, key=0, device="cpu")
    locs_hat = np.sort(res.samples["locs"].numpy().reshape(-1, 2), axis=1).mean(0)
    np.testing.assert_allclose(locs_hat, [-2.0, 2.0], atol=0.25)
    assert res.diagnostics["num_divergences"] == 0


@pytest.mark.slow
def test_poisson_hmm_nuts_recovers_rates():
    ys, _ = _gen_poisson(t=200, seed=5)
    res = sample(_poisson_model("torch", ys), kernel=NUTS(max_depth=7), num_samples=400,
                 num_warmup=400, num_chains=4, key=0, device="cpu")
    r_hat = np.sort(res.samples["rates"].numpy().reshape(-1, 2), axis=1).mean(0)
    assert abs(r_hat[0] - 1.0) < 0.4 and abs(r_hat[1] - 8.0) < 1.2, r_hat
