"""Port parity: exact enumeration of discrete latents (brancher_torch
against brancher_tpu's compiler enumeration stack).

The models are those of ``tests/test_discrete_latents.py``, built in both
packages from the same numpy inputs.  Each enumerated density and its
gradient in z is held to JAX's within 1e-4 * max(1, |value|) (f32 sums
over up to a few hundred terms in two libraries, through logsumexps);
responsibilities and forward-backward marginals within 1e-5.  Both
packages must choose the same path, refuse the same models with the same
ValueError, and agree on every ``check_*`` verdict.  The inference entry
points are held in ``test_torch_enumeration_inference.py``."""
import itertools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_torch as BT
import brancher_torch.functions as BFT
import brancher_tpu as BJ
import brancher_tpu.functions as BFJ
from brancher_torch.inference import NUTS, sample

torch.set_num_threads(2)
TOL = 1e-4
TOL_PROB = 1e-5

PKGS = {"jax": (BJ, BFJ, jnp.asarray), "torch": (BT, BFT, torch.as_tensor)}


def _mixture_model(pkg, data, k=2):
    P, BF, arr = PKGS[pkg]
    mu = P.NormalVariable(np.zeros(k, np.float32), 3.0 * np.ones(k, np.float32), "mu")
    z = P.CategoricalVariable(probs=np.ones(k, np.float32) / k, name="z",
                              plate_shape=(data.shape[0],))
    x = P.NormalVariable(BF.take(mu, z), 0.5, "x")
    x.observe(data)
    return P.ProbabilisticModel([x])


def _make_mixture_data(n=40, seed=0):
    rng = np.random.RandomState(seed)
    comp = rng.randint(0, 2, n)
    return (np.asarray([-2.0, 2.0])[comp] + 0.5 * rng.normal(size=n)).astype(np.float32), comp


_A = np.asarray([[0.9, 0.1], [0.2, 0.8]], np.float32)


def _chain_hmm_model(pkg, data):
    P, BF, arr = PKGS[pkg]
    mu = P.NormalVariable(0.0, 3.0, "mu")
    s = P.CategoricalVariable(probs=np.asarray([0.5, 0.5], np.float32), name="s0")
    states = [s]
    for t in range(1, data.shape[0]):
        s = P.CategoricalVariable(probs=BF.take(_A, s, axis=0), name=f"s{t}")
        states.append(s)
    outs = []
    for t, st in enumerate(states):
        x = P.NormalVariable(2.0 * (2.0 * st - 1.0) + mu, 0.6, f"x{t}")
        x.observe(np.float32(data[t]))
        outs.append(x)
    return P.ProbabilisticModel(outs)


def _make_chain_data(t_n=12, mu=0.5, seed=3):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 2)
    xs = []
    for _ in range(t_n):
        xs.append(mu + 2.0 * (2 * s - 1) + 0.6 * rng.normal())
        s = rng.choice(2, p=_A[s])
    return np.asarray(xs, np.float32)


def _three_way_model(pkg):
    P, BF, arr = PKGS[pkg]
    d1, d2, d3 = (P.BernoulliVariable(p, name=n) for p, n in ((0.4, "d1"), (0.5, "d2"), (0.6, "d3")))
    mu = P.NormalVariable(0.0, 2.0, "mu")
    y = P.NormalVariable(mu + d1 + 0.5 * d2 - d3 + 2.0 * d1 * d2 * d3, 0.7, "y")
    y.observe(np.float32(1.2))
    return P.ProbabilisticModel([y])


def _nonadjacent_model(pkg):
    P, BF, arr = PKGS[pkg]
    d1, d2, d3 = (P.BernoulliVariable(p, name=n) for p, n in ((0.3, "d1"), (0.5, "d2"), (0.7, "d3")))
    mu = P.NormalVariable(0.0, 2.0, "mu")
    y = P.NormalVariable(mu + d1 + d2 + 1.5 * d1 * d3, 0.6, "y")
    y.observe(np.float32(0.9))
    return P.ProbabilisticModel([y])


def _plated_pair_model(pkg, e=3):
    P, BF, arr = PKGS[pkg]
    mu = P.NormalVariable(0.0, 2.0, "mu")
    z1 = P.BernoulliVariable(0.4, name="z1", plate_shape=(e,))
    z2 = P.BernoulliVariable(logits=1.5 * z1 - 0.5, name="z2")
    y = P.NormalVariable(mu + z1 + 0.5 * z2 + 1.2 * z1 * z2, 0.7, "y")
    y.observe(np.linspace(-0.5, 1.5, e).astype(np.float32))
    return P.ProbabilisticModel([y])


def _mixed_scalar_plated_model(pkg, e=3, k_r=3):
    P, BF, arr = PKGS[pkg]
    r = P.CategoricalVariable(logits=np.zeros(k_r, np.float32), name="r")
    z1 = P.BernoulliVariable(logits=0.8 * r - 1.0, name="z1", plate_shape=(e,))
    mu = P.NormalVariable(0.0, 2.0, "mu")
    y = P.NormalVariable(mu + z1 * (0.5 + 1.0 * r), 0.7, "y")
    y.observe(np.linspace(-0.5, 1.5, e).astype(np.float32))
    return P.ProbabilisticModel([y])


def _interval_jacobian_model(pkg):
    P, BF, arr = PKGS[pkg]
    z1 = P.BernoulliVariable(probs=0.3, name="z1", plate_shape=(2,))
    z2 = P.BernoulliVariable(logits=1.5 * z1 - 0.5, name="z2")
    u = P.UniformVariable(0.0, 1.0 + z1, "u")  # bounds follow z1
    y = P.NormalVariable(u + z2, 0.7, "y", observed=np.asarray([1.2, -0.3], np.float32))
    return P.ProbabilisticModel([y])


def _cross_element_model(pkg):
    P, BF, arr = PKGS[pkg]
    z1 = P.BernoulliVariable(0.5, name="z1", plate_shape=(3,))
    y = P.NormalVariable(2.0 * BF.prod(z1), 0.5, "y")
    y.observe(np.float32(1.5))
    return P.ProbabilisticModel([y])


def _markov_hmm_model(pkg, t_len, k=3, seed=0, emission_scale=0.7, data=None):
    P, BF, arr = PKGS[pkg]
    from importlib import import_module

    D = import_module(P.__name__ + ".distributions")
    SP = import_module(P.__name__ + ".stochastic_processes")
    tl = arr(np.random.RandomState(0).normal(0, 1.5, (k, k)).astype(np.float32))
    s = SP.MarkovProcess(t_len, D.Categorical(), lambda prev: {"logits": tl[prev]},
                         init_dist=D.Categorical(),
                         init_links={"logits": np.zeros(k, np.float32)}, name="s")
    locs = P.NormalVariable(np.zeros(k, np.float32), 2.0 * np.ones(k, np.float32), "locs")
    y = P.NormalVariable(BF.take(locs, s), emission_scale, "y")
    if data is None:
        data = np.random.RandomState(seed).normal(0, 2, t_len).astype(np.float32)
        y.observe(data)
    else:
        SP.observe_timeseries(y, data)
    return P.ProbabilisticModel([y])


def _bernoulli_chain_model(pkg, t_len=10, transition=None):
    """A Bernoulli MarkovProcess (K=2 without a probe) with a continuous
    offset in its Normal emissions."""
    P, BF, arr = PKGS[pkg]
    from importlib import import_module

    D = import_module(P.__name__ + ".distributions")
    SP = import_module(P.__name__ + ".stochastic_processes")
    s = SP.MarkovProcess(t_len, D.Bernoulli(),
                         transition or (lambda prev: {"logits": 2.0 * prev - 1.0}),
                         init_dist=D.Bernoulli(), init_links={"probs": np.float32(0.4)}, name="s")
    mu = P.NormalVariable(0.0, 2.0, "mu")
    y = P.NormalVariable(2.0 * s - 1.0 + mu, 0.5, "y")
    y.observe(np.random.RandomState(7).normal(0, 1.5, t_len).astype(np.float32))
    return P.ProbabilisticModel([y])


def _cumsum_chain_model(pkg, t_len=8, k=2):
    P, BF, arr = PKGS[pkg]
    from importlib import import_module

    D = import_module(P.__name__ + ".distributions")
    SP = import_module(P.__name__ + ".stochastic_processes")
    lt = arr(np.zeros((k, k), np.float32))
    s = SP.MarkovProcess(t_len, D.Categorical(), lambda prev: {"logits": lt[prev]},
                         init_dist=D.Categorical(),
                         init_links={"logits": np.zeros(k, np.float32)}, name="s")
    drift = P.NormalVariable(0.0, 1.0, "drift")
    y = P.NormalVariable(BF.cumsum(s) * 1.0 + drift, 0.5, "y")
    y.observe(np.zeros(t_len, np.float32))
    return P.ProbabilisticModel([y])


def _pair(make, *args):
    return make("jax", *args).compiled(), make("torch", *args).compiled("cpu")


def _random_z(tc, seed):
    rng = np.random.RandomState(seed)
    return {n: rng.normal(0, 0.7, s).astype(np.float32) for n, s in tc.z_shapes.items()}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def _value_and_grad(jc, tc, method, z_np, **kw):
    """(port value, port grad, JAX value, JAX grad) of ``method`` at z."""
    jfn = getattr(jc, method)
    jp = jc.initial_params
    v_j, g_j = jax.jit(jax.value_and_grad(lambda z: jfn(jp, z, **kw)))(
        {k: jnp.asarray(v) for k, v in z_np.items()})
    zt = {k: torch.tensor(v, requires_grad=True) for k, v in z_np.items()}
    v_t = getattr(tc, method)(tc.initial_params, zt, **kw)
    grads = torch.autograd.grad(v_t, list(zt.values()))
    return float(v_t.detach()), dict(zip(zt, grads)), float(v_j), g_j


def _assert_density_parity(jc, tc, method, seeds=(0, 1)):
    for seed in seeds:
        z = _random_z(tc, seed)
        v_t, g_t, v_j, g_j = _value_and_grad(jc, tc, method, z)
        _close(v_t, v_j, TOL, f"{method} value")
        for n in z:
            _close(g_t[n].numpy(), np.asarray(g_j[n]), TOL, f"{method} d/d{n}")


def _same_dispatch(jc, tc):
    jf = jc.enum_log_density_fn(jc.initial_params)
    tf = tc.enum_log_density_fn(tc.initial_params)
    assert tf.__name__ == jf.__name__
    return tf.__name__


CASES = {
    "elementwise": (lambda: _pair(_mixture_model, _make_mixture_data(6, 1)[0]),
                    "enumerated_log_density"),
    "chain": (lambda: _pair(_chain_hmm_model, _make_chain_data(6)), "chain_enumerated_log_density"),
    "factor_three_way": (lambda: _pair(_three_way_model), "factor_enumerated_log_density"),
    "factor_nonadjacent": (lambda: _pair(_nonadjacent_model), "factor_enumerated_log_density"),
    "group_plated_pair": (lambda: _pair(_plated_pair_model, 3), "group_enumerated_log_density"),
    "group_mixed": (lambda: _pair(_mixed_scalar_plated_model), "group_enumerated_log_density"),
    "group_interval_jacobian": (lambda: _pair(_interval_jacobian_model),
                                "group_enumerated_log_density"),
    "sequence": (lambda: _pair(_markov_hmm_model, 12, 3), "sequence_enumerated_log_density"),
    "sequence_bernoulli": (lambda: _pair(_bernoulli_chain_model), "sequence_enumerated_log_density"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_enumerated_density_and_gradient_match_jax(case):
    make, method = CASES[case]
    jc, tc = make()
    assert _same_dispatch(jc, tc) == method
    _assert_density_parity(jc, tc, method)


@pytest.mark.parametrize("case", list(CASES))
def test_enumerated_density_matches_bruteforce(case):
    """The port's density against the logsumexp of log_density_z over
    every joint assignment (at most 2^10 here)."""
    make, method = CASES[case]
    _, tc = make()
    p = tc.initial_params
    z = {k: torch.as_tensor(v) for k, v in _random_z(tc, 3).items()}
    names = [n for n in tc.discrete_latent_names]
    shapes = [tc.shapes[n] for n in names]
    if case == "sequence":
        t_len, k = 6, 3  # a shorter chain of the same model: 3^6 paths
        tc = _markov_hmm_model("torch", t_len, k).compiled("cpu")
        p, z = tc.initial_params, {"locs": z["locs"]}
        choices = [range(k)] * t_len
        assigns = ({"s": torch.tensor(a)} for a in itertools.product(*choices))
    elif case == "sequence_bernoulli":
        choices = [range(2)] * tc.shapes["s"][0]
        assigns = ({"s": torch.tensor(a)} for a in itertools.product(*choices))
    else:
        cards = {n: k for n, _s, k in tc.discrete_enum_info(p)}
        sizes = [int(np.prod(s)) for s in shapes]
        flat = itertools.product(*[itertools.product(range(cards[n]), repeat=sz)
                                   for n, sz in zip(names, sizes)])
        assigns = ({n: torch.tensor(a).reshape(s) for n, a, s in zip(names, combo, shapes)}
                   for combo in flat)
    lps = torch.stack([tc.log_density_z(p, z, a) for a in assigns])
    got = getattr(tc, method)(p, z)
    _close(float(got), float(torch.logsumexp(lps, 0)), TOL)


def test_responsibilities_and_marginals_match_jax():
    z = {"mu": np.asarray([-1.5, 1.2], np.float32)}
    jc, tc = _pair(_mixture_model, _make_mixture_data(6, 1)[0])
    _, rj = jax.jit(lambda zz: jc.enumerated_log_density(
        jc.initial_params, zz, return_responsibilities=True))({"mu": jnp.asarray(z["mu"])})
    _, rt = tc.enumerated_log_density(tc.initial_params, {"mu": torch.as_tensor(z["mu"])},
                                      return_responsibilities=True)
    _close(rt["z"].numpy(), np.asarray(rj["z"]), TOL_PROB, "mixture responsibilities")

    jc, tc = _pair(_chain_hmm_model, _make_chain_data(6))
    _, mj = jax.jit(lambda zz: jc.chain_enumerated_log_density(
        jc.initial_params, zz, return_marginals=True))({"mu": jnp.asarray(1.3)})
    _, mt = tc.chain_enumerated_log_density(tc.initial_params, {"mu": torch.tensor(1.3)},
                                            return_marginals=True)
    assert set(mt) == set(mj)
    for n in mj:
        _close(mt[n].numpy(), np.asarray(mj[n]), TOL_PROB, f"chain marginal {n}")

    for make in (_plated_pair_model, _mixed_scalar_plated_model):
        jc, tc = _pair(make)
        _, rj = jax.jit(lambda zz, _jc=jc: _jc.group_enumerated_log_density(
            _jc.initial_params, zz, return_responsibilities=True))({"mu": jnp.asarray(0.4)})
        _, rt = tc.group_enumerated_log_density(tc.initial_params, {"mu": torch.tensor(0.4)},
                                                return_responsibilities=True)
        assert set(rt) == set(rj)
        for n in rj:
            assert tuple(rt[n].shape) == tuple(rj[n].shape)
            _close(rt[n].numpy(), np.asarray(rj[n]), TOL_PROB, f"group marginal {n}")

    jc, tc = _pair(_markov_hmm_model, 12, 3)
    locs = np.random.RandomState(2).normal(0, 1, 3).astype(np.float32)
    _, mj = jax.jit(lambda zz: jc.sequence_enumerated_log_density(
        jc.initial_params, zz, return_marginals=True))({"locs": jnp.asarray(locs)})
    _, mt = tc.sequence_enumerated_log_density(tc.initial_params, {"locs": torch.as_tensor(locs)},
                                               return_marginals=True)
    assert mt["s"].shape == (12, 3)
    _close(mt["s"].numpy(), np.asarray(mj["s"]), TOL_PROB, "sequence marginals")


VERDICT_MODELS = {
    "mixture": lambda pkg: _mixture_model(pkg, _make_mixture_data(6, 1)[0]),
    "chain": lambda pkg: _chain_hmm_model(pkg, _make_chain_data(6)),
    "three_way": _three_way_model,
    "nonadjacent": _nonadjacent_model,
    "plated_pair": _plated_pair_model,
    "mixed": _mixed_scalar_plated_model,
    "interval_jacobian": _interval_jacobian_model,
    "cross_element": _cross_element_model,
    "sequence": lambda pkg: _markov_hmm_model(pkg, 8, 3),
    "sequence_bernoulli": _bernoulli_chain_model,
    "cross_timestep": _cumsum_chain_model,
}


@pytest.mark.parametrize("name", list(VERDICT_MODELS))
def test_verdicts_and_dispatch_agree_with_jax(name):
    """Every check_* verdict, the chain/structure probes, and the chosen
    method or the refusal, as in JAX."""
    jc, tc = VERDICT_MODELS[name]("jax").compiled(), VERDICT_MODELS[name]("torch").compiled("cpu")
    jp, tp = jc.initial_params, tc.initial_params
    assert (tc._sequence_chain_info(tp) is None) == (jc._sequence_chain_info(jp) is None)
    if jc._sequence_chain_info(jp) is not None:
        assert tc._sequence_chain_info(tp) == jc._sequence_chain_info(jp)
        assert tc.check_sequence_factorization(tp) == jc.check_sequence_factorization(jp)
    else:
        assert tc.discrete_enum_info(tp) == jc.discrete_enum_info(jp)
        assert tc.check_enum_factorization(tp) == jc.check_enum_factorization(jp)
        assert tc.check_chain_factorization(tp) == jc.check_chain_factorization(jp)
        assert tc.check_group_factorization(tp) == jc.check_group_factorization(jp)
        assert tc.discrete_chain_info(tp) == (None if jc.discrete_chain_info(jp) is None
                                              else tuple(jc.discrete_chain_info(jp)))
        assert tc.discrete_chain_structure() == jc.discrete_chain_structure()
        assert tc._enum_groups() == jc._enum_groups()
    try:
        want = jc.enum_log_density_fn(jp).__name__
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tc.enum_log_density_fn(tp)
        assert str(got.value) == str(e)
        return
    assert tc.enum_log_density_fn(tp).__name__ == want


def test_transition_returning_numbers_matches_jax():
    """A discrete chain whose transition returns a Python number: its
    parameter is a float (not the previous state's integer dtype)."""
    make = lambda pkg: _bernoulli_chain_model(pkg, 8, lambda prev: {"probs": 0.3})  # noqa: E731
    jc, tc = make("jax").compiled(), make("torch").compiled("cpu")
    assert _same_dispatch(jc, tc) == "sequence_enumerated_log_density"
    _assert_density_parity(jc, tc, "sequence_enumerated_log_density")


def test_cross_coupling_refusals_name_the_coupling():
    tc = _cross_element_model("torch").compiled("cpu")
    assert not tc.check_group_factorization(tc.initial_params)
    with pytest.raises(ValueError, match="cross-element"):
        tc.enum_log_density_fn(tc.initial_params)
    tc = _cumsum_chain_model("torch").compiled("cpu")
    assert not tc.check_sequence_factorization(tc.initial_params)
    with pytest.raises(ValueError, match="cross-timestep"):
        tc.enum_log_density_fn(tc.initial_params)


def test_long_unrolled_chain_warns_and_small_stays_silent():
    comp = _chain_hmm_model("torch", _make_chain_data(80)).compiled("cpu")
    with pytest.warns(UserWarning, match="MarkovSeries"):
        comp.enum_log_density_fn(comp.initial_params)
    small = _chain_hmm_model("torch", _make_chain_data(6)).compiled("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        small.enum_log_density_fn(small.initial_params)


def test_structural_chain_tables_match_probe():
    """The structural extractor and the probe path give the same forward
    total (their tables differ by per-table constants)."""
    comp = _chain_hmm_model("torch", _make_chain_data(8)).compiled("cpu")
    p = comp.initial_params
    names = comp.discrete_chain_structure()
    assert names == [f"s{t}" for t in range(8)]
    z = {"mu": torch.tensor(0.4)}

    def fwd(b, u, psi):
        alpha = u[0]
        for t in range(1, len(names)):
            alpha = torch.logsumexp(alpha[:, None] + psi[t - 1], 0) + u[t]
        return float(b + torch.logsumexp(alpha, 0))

    assert abs(fwd(*comp._chain_tables_structural(p, z, {}, names, 2))
               - fwd(*comp._chain_tables(p, z, {}, names, 2))) < 1e-3


def test_sequence_enumeration_with_timeseries_gaps_matches_jax():
    """observe_timeseries with NaN gaps on the emission of a sequence HMM:
    the mask drops the missing emission terms inside the enumeration."""
    data = np.random.RandomState(5).normal(0, 2, 12).astype(np.float32)
    data[[2, 3, 9]] = np.nan
    jc, tc = _pair(lambda pkg: _markov_hmm_model(pkg, 12, 3, data=data))
    assert _same_dispatch(jc, tc) == "sequence_enumerated_log_density"
    _assert_density_parity(jc, tc, "sequence_enumerated_log_density")
    filled = np.nan_to_num(data)
    full = _markov_hmm_model("torch", 12, 3).compiled("cpu")
    z = {"locs": torch.tensor([0.3, -1.0, 1.2])}
    masked = tc.sequence_enumerated_log_density(tc.initial_params, z)
    unmasked_model = _markov_hmm_model("torch", 12, 3)
    unmasked_model.get_variable("y").observe(filled)
    assert abs(float(masked) - float(unmasked_model.compiled("cpu").sequence_enumerated_log_density(
        unmasked_model.compiled("cpu").initial_params, z))) > 1.0
    del full


def test_dispatch_is_cached_and_density_reads_only_cached_structure(monkeypatch):
    """The dispatch runs its probes once; later calls of the density make no
    probe and no host read of the structure (no ``float``/``item``)."""
    comp = _markov_hmm_model("torch", 10, 3).compiled("cpu")
    p = comp.initial_params
    fn = comp.enum_log_density_fn(p)
    assert comp.enum_log_density_fn(p) is fn

    def boom(*a, **k):
        raise AssertionError("probed again")

    for name in ("check_sequence_factorization", "check_enum_factorization",
                 "check_chain_factorization", "check_group_factorization",
                 "_zero_walk_values"):
        monkeypatch.setattr(comp, name, boom)
    assert comp.enum_log_density_fn(p) is fn
    monkeypatch.setattr(torch.Tensor, "item", boom)
    monkeypatch.setattr(torch.Tensor, "__float__", boom)
    z = torch.randn(4, comp.dim)
    vals = torch.func.vmap(lambda zf: fn(p, comp.unravel_z(zf)))(z)
    assert vals.shape == (4,)


def test_sample_twice_reuses_the_enumerated_potential(monkeypatch):
    """A second sample() hits the cached potential without re-running the
    factorization probes, and draws the same chains."""
    model = _chain_hmm_model("torch", _make_chain_data(6))
    comp = model.compiled("cpu")
    kw = dict(kernel=NUTS(max_depth=5), num_samples=20, num_warmup=20, num_chains=2,
              enumerate_discrete=True, device="cpu")
    r1 = sample(model, key=0, **kw)
    assert comp._enum_potential_cache

    def boom(*a, **k):
        raise AssertionError("re-probed on second sample()")

    monkeypatch.setattr(comp, "check_enum_factorization", boom)
    monkeypatch.setattr(comp, "enum_log_density_fn", boom)
    r2 = sample(model, key=0, **kw)
    assert torch.equal(r1.samples["mu"], r2.samples["mu"])


def test_group_enumeration_uses_structural_tables(monkeypatch):
    """No full-density walk (``log_density_z``) in the structural group
    path; a model whose structural tables fail at dispatch takes the probe
    path, with the same value."""
    comp = _plated_pair_model("torch", 3).compiled("cpu")
    p = comp.initial_params
    fn = comp.enum_log_density_fn(p)
    assert fn.__name__ == "group_enumerated_log_density"
    calls = {"n": 0}
    orig = type(comp).log_density_z

    def counting(self, *a, **k):
        calls["n"] += 1
        return orig(self, *a, **k)

    monkeypatch.setattr(type(comp), "log_density_z", counting)
    z = {"mu": torch.tensor(0.6)}
    val = float(fn(p, z))
    assert np.isfinite(val) and calls["n"] == 0
    monkeypatch.undo()

    def raising(*a, **k):
        raise ValueError("force the probe path")

    fresh = _plated_pair_model("torch", 3).compiled("cpu")
    monkeypatch.setattr(type(fresh), "_group_tables_structural", raising)
    fp = fresh.initial_params
    assert not any(plan[-1] for plan in fresh._group_plan(fp, {}).values())
    np.testing.assert_allclose(float(fresh.group_enumerated_log_density(fp, z)), val, rtol=1e-5)


def test_enumerated_potential_cache_keeps_the_last_eight_givens():
    """Twelve sample() calls with twelve different ``given``s on one compiled
    mixture leave eight cached potentials, the oldest evicted first, as
    JAX's ``_comp_cache(..., cap=8)``; an equal ``given`` in new tensors
    hits its entry (keyed by content, sha1 of the bytes)."""
    from brancher_torch.inference import mcmc

    data, _ = _make_mixture_data(20)
    model = _mixture_model("torch", data)
    comp = model.compiled("cpu")
    kw = dict(kernel=NUTS(max_depth=2), num_samples=1, num_warmup=0, num_chains=2,
              enumerate_discrete=True, diagnostics_backend="none", device="cpu")
    givens = [{"x": torch.as_tensor(data + 0.1 * i)} for i in range(12)]
    for i, g in enumerate(givens):
        sample(model, key=i, given=g, **kw)
    cache = comp._enum_potential_cache
    keys = [mcmc._given_key(g) for g in givens]
    assert all(len(k[0][3]) == 40 for k in keys)  # sha1 hex digests
    assert list(cache) == keys[4:]
    last = cache[keys[-1]]
    sample(model, key=0, given={"x": torch.as_tensor(data + 0.1 * 11)}, **kw)
    assert list(cache) == keys[4:] and cache[keys[-1]] is last


def _mixture_with_a_plate(n):
    """The four-point mixture beside ``w`` ~ N(mu[0], 1) over ``n`` points."""
    data, _ = _make_mixture_data(4)
    mu = BT.NormalVariable(np.zeros(2, np.float32), 3.0 * np.ones(2, np.float32), "mu")
    z = BT.CategoricalVariable(probs=np.ones(2, np.float32) / 2, name="z", plate_shape=(4,))
    x = BT.NormalVariable(BFT.take(mu, z), 0.5, "x")
    x.observe(data)
    w = BT.NormalVariable(mu[0], 1.0, "w", plate_shape=(n,))
    w.observe(np.zeros(n, np.float32))
    return BT.ProbabilisticModel([x, w])


def test_a_given_over_16_mb_is_neither_copied_nor_hashed_nor_cached(monkeypatch):
    """A ``given`` leaf over 1 << 24 bytes gets no key before any host copy
    or hash (JAX ``_content_key``'s bail), and every sample() with it builds
    a fresh enumerated potential that is not cached; one byte less is
    keyed and cached."""
    from brancher_torch.inference import mcmc

    n = (1 << 22) + 1  # 16 MB + 4 bytes of f32
    rng = np.random.RandomState(0)
    big = {"w": torch.as_tensor(rng.normal(size=n).astype(np.float32))}
    fits = {"w": torch.as_tensor(rng.normal(size=n - 1).astype(np.float32))}

    def boom(*a, **k):
        raise AssertionError("the large given was copied or hashed")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "numpy", boom)
        m.setattr(torch.Tensor, "cpu", boom)
        m.setattr(mcmc.hashlib, "sha1", boom)
        assert mcmc._given_key(big) is None
    assert mcmc._given_key(fits) is not None
    built = []
    orig = mcmc.make_enum_potential

    def counting(*a, **k):
        built.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(mcmc, "make_enum_potential", counting)
    kw = dict(kernel=NUTS(max_depth=1), num_samples=1, num_warmup=0, num_chains=1,
              enumerate_discrete=True, diagnostics_backend="none", device="cpu")
    model = _mixture_with_a_plate(n)
    for _ in range(2):
        sample(model, key=0, given=big, **kw)
    assert len(built) == 2
    assert not model.compiled("cpu").__dict__.get("_enum_potential_cache")
    model = _mixture_with_a_plate(n - 1)
    for _ in range(2):
        sample(model, key=0, given=fits, **kw)
    assert len(built) == 3 and len(model.compiled("cpu")._enum_potential_cache) == 1
