"""Port parity: the auxiliary modules (pandas interface, the DataFrame
methods, plots, metrics, the MCMC summary, the dashboard, utilities and
config) against brancher_tpu's, on the same numpy inputs.

Deterministic functions are held to JAX's within 1e-6 relative (f32
log-densities summed over a few terms in two libraries: 1e-5); the
dashboard's stats table prints three significant digits, so its cells are
held to one unit of the third digit (R-hat, printed to three decimals,
to 1e-3).  The port's draws come from a ``torch.Generator``, so sampling
flows (``get_sample``, ``posterior_predictive``) are held in distribution:
shapes, supports, and moments within their Monte-Carlo error.  These are
ports of ``tests/test_io_aux.py`` and of the tutorials' first calls."""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_torch as BT
import brancher_torch.functions as BFT
import brancher_tpu as BJ
import brancher_tpu.functions as BFJ

torch.set_num_threads(2)


def _simple_model(P, BF, data):
    mu = P.NormalVariable(0.0, 2.0, "mu")
    sigma = P.LogNormalVariable(0.0, 0.5, "sigma")
    x = P.NormalVariable(BF.exp(mu * 0.1) + mu, sigma, "x")
    x.observe(data)
    return P.ProbabilisticModel([x])


def _tutorial1_model(P):
    """tutorials/01_getting_started.py:40-48."""
    mu = P.NormalVariable(0.0, 2.0, "mu")
    sigma = P.LogNormalVariable(0.0, 0.25, "sigma")
    x = P.NormalVariable(mu, sigma, "x", plate_shape=(30,))
    x.observe((2.0 + 0.4 * np.random.RandomState(0).randn(30)).astype(np.float32))
    return P.ProbabilisticModel([x])


def _draws(seed=0, shape=(4, 100, 3)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- pandas interface and the DataFrame methods ----------------------------

def test_dataframe_conversions_match_jax():
    from brancher_torch import pandas_interface as TP
    from brancher_tpu import pandas_interface as JP

    raw = {"a": _draws(0, (6,)), "b": _draws(1, (6, 2, 3)), "c": np.float32(1.5)}
    df_j = JP.sample_dict_to_dataframe({k: jnp.asarray(v) for k, v in raw.items()})
    df_t = TP.sample_dict_to_dataframe({k: torch.as_tensor(v) for k, v in raw.items()})
    assert list(df_t.columns) == list(df_j.columns) and len(df_t) == len(df_j) == 6
    back_j, back_t = JP.dataframe_to_sample_dict(df_j), TP.dataframe_to_sample_dict(df_t)
    for k in raw:
        np.testing.assert_array_equal(back_t[k], back_j[k])
        assert back_t[k].dtype == back_j[k].dtype
    co_j = JP.coerce_to_sample_dict(df_j)
    co_t = TP.coerce_to_sample_dict(df_t, device="cpu")
    for k in raw:
        assert co_t[k].dtype == torch.float32 and str(co_j[k].dtype) == "float32"
        np.testing.assert_array_equal(co_t[k].numpy(), np.asarray(co_j[k]))
    # {Variable: array} mappings and host floats (float64 -> the default float)
    mu = BT.NormalVariable(0.0, 1.0, "mu")
    got = TP.coerce_to_sample_dict({mu: np.asarray([0.5, 1.0])}, device="cpu")
    assert got["mu"].dtype == torch.float32 and got["mu"].tolist() == [0.5, 1.0]
    assert TP.reformat_sample_to_pandas(raw).equals(TP.sample_dict_to_dataframe(raw))


def test_calculate_log_probability_and_mean_one_match_jax():
    data = np.random.RandomState(0).randn(20).astype(np.float32) + 2
    mj, mt = _simple_model(BJ, BFJ, data), _simple_model(BT, BFT, data)
    values = {"mu": np.asarray([0.5, -0.3, 1.2], np.float32),
              "sigma": np.asarray([1.0, 0.7, 2.0], np.float32)}
    lj = np.asarray(mj.calculate_log_probability({k: jnp.asarray(v) for k, v in values.items()}))
    lt = mt.calculate_log_probability(values, device="cpu")
    assert lt.dtype == torch.float32 and lt.shape == (3,)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-5)
    # a DataFrame and a {Variable: array} mapping give the same numbers
    from brancher_torch.pandas_interface import sample_dict_to_dataframe

    df = sample_dict_to_dataframe(values)
    np.testing.assert_array_equal(mt.calculate_log_probability(df, device="cpu").numpy(), lt.numpy())
    byvar = {mt.get_variable(k): v for k, v in values.items()}
    np.testing.assert_array_equal(mt.calculate_log_probability(byvar, device="cpu").numpy(), lt.numpy())

    cj, ct = mj.compiled(), mt.compiled("cpu")
    for given in (None, {"mu": 0.7}):
        mean_j = cj.mean_one(cj.initial_params, None,
                             None if given is None else {k: jnp.asarray(v) for k, v in given.items()})
        mean_t = ct.mean_one(ct.initial_params, given=given)
        assert set(mean_t) == set(mean_j)
        for k in mean_j:
            np.testing.assert_allclose(mean_t[k].numpy(), np.asarray(mean_j[k]), rtol=1e-6)


def test_tutorial_one_get_sample_runs_on_the_port():
    """tutorials/01_getting_started.py:59: ``model.get_sample(5)`` is a
    DataFrame with one column per variable; its draws follow the priors."""
    model = _tutorial1_model(BT)
    df = model.get_sample(5, key=0, device="cpu")
    assert list(df.columns) == ["mu", "sigma", "x"] and len(df) == 5
    assert df[["mu", "sigma"]].round(3).shape == (5, 2)
    assert np.stack(df["x"].to_numpy()).shape == (5, 30)
    big = model.get_sample_dict(4000, key=1, device="cpu")
    mu, sigma = big["mu"].numpy(), big["sigma"].numpy()
    assert abs(mu.mean()) < 4 * 2.0 / np.sqrt(4000) and abs(mu.std() - 2.0) < 0.1
    assert (sigma > 0).all() and abs(np.log(sigma).std() - 0.25) < 0.02
    # the posterior-model DataFrame: a guide pushed through the model by name
    q = BT.ProbabilisticModel([BT.NormalVariable(2.0, 0.1, "mu"),
                               BT.LogNormalVariable(np.log(0.4), 0.1, "sigma")])
    model.set_posterior_model(q)
    post = model.get_posterior_sample(2000, key=2, device="cpu")
    assert list(post.columns) == ["mu", "sigma", "x"] and len(post) == 2000
    assert abs(post["mu"].mean() - 2.0) < 0.02


def test_tutorial_two_posterior_predictive_runs_on_the_port():
    """tutorials/02_bayesian_logistic_regression.py:94-96 at a tiny size:
    thinned posterior draws give Bernoulli draws of y whose majority agrees
    with the data on over 70 % of the points (held in distribution, not to
    JAX's numbers: the thinning deviates)."""
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    x, y, _ = make_logreg_data(200, 5)
    model = logistic_regression_model(x, y)
    res = sample(model, kernel=NUTS(max_depth=6), num_samples=100, num_warmup=150,
                 num_chains=4, device="cpu", key=2)
    ppc = res.posterior_predictive(model, num_draws=50, key=3)
    assert ppc["y"].shape == (50, 200) and ppc["w"].shape == (50, 5)
    assert set(np.unique(ppc["y"].numpy())) <= {0, 1}
    # every draw of w is a posterior draw, none repeated (without replacement)
    flat = res.samples["w"].reshape(-1, 5)
    rows = {tuple(r) for r in flat.numpy().tolist()}
    assert all(tuple(r) in rows for r in ppc["w"].numpy().tolist())
    assert len({tuple(r) for r in ppc["w"].numpy().tolist()}) == 50
    acc = float((ppc["y"].float().mean(0).round().numpy() == y).mean())
    assert acc > 0.7, acc
    # the same key thins the same draws; all of them when asked for all
    again = res.posterior_predictive(model, num_draws=50, key=3)
    assert torch.equal(again["w"], ppc["w"]) and torch.equal(again["y"], ppc["y"])
    assert res.posterior_predictive(model, num_draws=400, key=0)["w"].shape == (400, 5)
    with pytest.raises(ValueError, match="num_draws"):
        res.posterior_predictive(model, num_draws=401)
    df = res.to_pandas()
    assert list(df.columns) == ["w"] and len(df) == 400
    np.testing.assert_array_equal(np.stack(df["w"].to_numpy()), flat.numpy())


# -- plots, metrics, summary, dashboard (ports of test_io_aux.py) -----------

def _bar_heights(fig):
    return [[p.get_height() for p in ax.patches] for ax in fig.axes]


def test_plot_functions_match_jax():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from brancher_torch import visualizations as TV
    from brancher_torch.pandas_interface import sample_dict_to_dataframe
    from brancher_tpu import visualizations as JV

    raw = {"mu": _draws(0, (200,)), "w": _draws(1, (200, 2))}
    df_t = sample_dict_to_dataframe(raw)
    df_j = JV._to_frame({k: jnp.asarray(v) for k, v in raw.items()})
    for fn in (lambda P, d: P.plot_posterior(d),
               lambda P, d: P.ensemble_histogram([d, d], "mu", labels=["a", "b"])):
        ft, fj = fn(TV, df_t), fn(JV, df_j)
        assert len(ft.axes) == len(fj.axes)
        assert _bar_heights(ft) == _bar_heights(fj)
        plt.close(ft), plt.close(fj)
    fig = TV.plot_density(df_t, variables=["mu"])
    assert fig is not None
    plt.close(fig)
    # an MCMCResult goes through to_pandas; a model through its loss curve
    from brancher_torch.inference.mcmc import MCMCResult

    res = MCMCResult({"mu": torch.as_tensor(_draws(2, (4, 50)))}, {}, {})
    fig = TV.plot_posterior(res)
    assert sum(len(h) for h in _bar_heights(fig)) > 0
    plt.close(fig)

    class Fitted:
        diagnostics = {"loss curve": np.linspace(3.0, 1.0, 20)}

    fig = TV.plot_loss_curve(Fitted())
    np.testing.assert_array_equal(fig.axes[0].lines[0].get_ydata(), Fitted.diagnostics["loss curve"])
    plt.close(fig)


def test_metrics_logger_matches_jax(tmp_path):
    from brancher_torch.metrics import MetricsLogger as TM
    from brancher_tpu.metrics import MetricsLogger as JM

    recs = {}
    for name, cls, arr in (("jax", JM, jnp.asarray), ("torch", TM, torch.as_tensor)):
        p = str(tmp_path / f"{name}.jsonl")
        ml = cls(p, tensorboard_dir=str(tmp_path / f"tb_{name}") if name == "torch" else None)
        ml.log(0, loss=1.5, accept=arr(0.8))
        ml.log(1, loss=arr(np.float32(1.2)))
        ml.close()
        lines = open(p).read().strip().splitlines()
        assert len(lines) == 2
        recs[name] = [{k: v for k, v in json.loads(ln).items() if k != "time"} for ln in lines]
    assert recs["torch"] == recs["jax"]
    assert recs["torch"][0] == {"step": 0, "loss": 1.5, "accept": float(np.float32(0.8))}
    assert list((tmp_path / "tb_torch").iterdir())  # TensorBoard wrote its event file


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from brancher_torch.metrics import TRACE_FILE, profile_trace

    with profile_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())
    assert log_dir == str(tmp_path / "trace")
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])


class _Result:
    """What summarize_mcmc and the dashboard read of an MCMCResult."""

    def __init__(self, samples, diagnostics):
        self.samples, self.diagnostics = samples, diagnostics


def test_mcmc_summary_matches_jax():
    from brancher_torch.metrics import summarize_mcmc as TS
    from brancher_tpu.metrics import summarize_mcmc as JS

    raw = {"mu": _draws(0, (2, 50)), "w": _draws(1, (2, 50, 3))}
    diag = {"ess": {"mu": np.float32(80.0)}, "r_hat": {"mu": np.float32(1.01)}}
    sj = JS(_Result({k: jnp.asarray(v) for k, v in raw.items()}, diag))
    st = TS(_Result({k: torch.as_tensor(v) for k, v in raw.items()}, diag))
    assert set(st) == set(sj) and set(st["mu"]) == {"mean", "sd", "ess", "r_hat"}
    assert set(st["w"]) == {"mean", "sd"}
    for name in sj:
        for k in sj[name]:
            np.testing.assert_allclose(st[name][k], np.asarray(sj[name][k]), rtol=1e-6)


def test_mcmc_summary_of_a_port_run():
    from brancher_torch.inference import HMC, sample
    from brancher_torch.metrics import summarize_mcmc
    from brancher_torch.models import conjugate_normal_model

    model, _ = conjugate_normal_model(num_obs=5)
    res = sample(model, kernel=HMC(num_integration_steps=5), num_samples=50, num_warmup=50,
                 num_chains=2, key=0, device="cpu")
    summary = summarize_mcmc(res)
    assert "mu" in summary and "ess" in summary["mu"]


def _stats_rows(html):
    table = html[html.index('<table class="stats">'):]
    return [[c for c in re.findall(r"<td>([^<]*)</td>", row)]
            for row in re.findall(r"<tr><td>.*?</tr>", table)]


def test_dashboard_stats_table_matches_jax(tmp_path):
    from brancher_torch.dashboard import export_dashboard_html as TD
    from brancher_tpu.dashboard import export_dashboard_html as JD

    raw = {"a": _draws(3, (4, 300)), "b": np.cumsum(_draws(4, (4, 300, 2)), axis=1)}
    tj = open(JD({k: v for k, v in raw.items()}, str(tmp_path / "j.html"))).read()
    tt = open(TD({k: torch.as_tensor(v) for k, v in raw.items()}, str(tmp_path / "t.html"))).read()
    rj, rt = _stats_rows(tj), _stats_rows(tt)
    assert len(rt) == len(rj) == 3 and [r[0] for r in rt] == ["a", "b[0]", "b[1]"]
    for row_t, row_j in zip(rt, rj):
        assert row_t[0] == row_j[0]
        for i, (a, b) in enumerate(zip(row_t[1:], row_j[1:])):
            x, y = float(a), float(b)
            tol = 1e-3 if i == 5 else 1e-2 * abs(y)  # R-hat .3f; else 3 significant digits
            assert abs(x - y) <= tol + 1e-12, (row_t, row_j)
    assert tt.count('class="panel"') == tj.count('class="panel"') == 3


def test_dashboard_export(tmp_path):
    """test_io_aux.py::test_dashboard_export on the port: panels per
    flattened coordinate, the stats table, tooltips and crosshair, dark
    mode, text never in series colours, the panel cap."""
    from brancher_torch.dashboard import export_dashboard_html
    from brancher_torch.inference import NUTS, sample

    mu = BT.NormalVariable(0.0, 2.0, "mu")
    x = BT.NormalVariable(mu, 1.0, "x", plate_shape=(3,))
    x.observe(np.asarray([0.5, 1.0, 1.5], np.float32))
    res = sample(BT.ProbabilisticModel([x]), kernel=NUTS(max_depth=6), num_samples=200,
                 num_warmup=200, num_chains=4, key=0, device="cpu")
    assert BT.export_dashboard_html is export_dashboard_html
    s = open(export_dashboard_html(res, str(tmp_path / "d.html"), title="t")).read()
    assert s.count('class="panel"') == 1  # mu (x observed)
    assert "<svg" in s and 'class="cross"' in s and "data-tt" in s
    assert "prefers-color-scheme: dark" in s
    assert "Summary table" in s and "R-hat" in s and "brancher_torch MCMC run" in s
    assert not re.findall(r'<text[^>]*fill="var\(--s\d', s)
    # the run's own ESS and R-hat fill the table
    row = _stats_rows(s)[0]
    assert float(row[5]) == pytest.approx(float(res.diagnostics["ess"]["mu"]), rel=1e-2)

    d = {"w": torch.as_tensor(np.random.RandomState(0).randn(4, 100, 7))}
    s2 = open(export_dashboard_html(d, str(tmp_path / "d2.html"), max_panels=5)).read()
    assert s2.count('class="panel"') == 5
    assert "truncated at max_panels" in s2


# -- utilities and config ---------------------------------------------------

def test_utilities_match_jax():
    from brancher_torch import utilities as TU
    from brancher_tpu import utilities as JU

    for value in (3, 2.5, [1, 2], np.arange(3), np.arange(3.0), np.asarray([True, False])):
        j, t = JU.to_array(value), TU.to_array(value)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert (t.dtype.is_floating_point, t.dtype == torch.bool) == (
            jnp.issubdtype(j.dtype, jnp.floating), j.dtype == jnp.bool_)
    assert TU.to_array(torch.ones(2)) is not None
    assert TU.broadcast_shapes((3, 1), (1, 4), (4,)) == tuple(JU.broadcast_shapes((3, 1), (1, 4), (4,)))
    x = _draws(0, (3, 4))
    assert float(TU.sum_all(torch.as_tensor(x))) == pytest.approx(float(JU.sum_all(jnp.asarray(x))), rel=1e-6)
    assert TU.merge_sample_dicts([{"a": 1, "b": 2}, {"b": 3}]) == JU.merge_sample_dicts([{"a": 1, "b": 2}, {"b": 3}])

    tree = {"w": _draws(1, (2, 3)), "b": (_draws(2, (4,)), np.float32(1.5)), "a": _draws(3, (1,))}
    fj, unj = JU.tree_flatten_concat(jax.tree_util.tree_map(jnp.asarray, tree))
    ft, unt = TU.tree_flatten_concat(jax.tree_util.tree_map(torch.as_tensor, tree))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))  # ravel_pytree's order
    back = unt(ft * 2)
    np.testing.assert_array_equal(back["b"][0].numpy(), np.asarray(unj(fj * 2)["b"][0]))
    assert back["w"].shape == (2, 3) and back["b"][1].shape == ()

    trees = [{"x": _draws(i, (2,)), "y": (_draws(i + 5, (3,)),)} for i in range(3)]
    sj = JU.tree_stack([jax.tree_util.tree_map(jnp.asarray, t) for t in trees])
    st = TU.tree_stack([jax.tree_util.tree_map(torch.as_tensor, t) for t in trees])
    np.testing.assert_array_equal(st["y"][0].numpy(), np.asarray(sj["y"][0]))
    np.testing.assert_array_equal(TU.tree_index(st, 1)["x"].numpy(), np.asarray(JU.tree_index(sj, 1)["x"]))


def test_split_key_dict_is_deterministic_per_name():
    """The documented deviation: one generator per name, a function of the
    seed and the name's index (JAX's fold_in has no torch counterpart)."""
    from brancher_torch.utilities import split_key_dict

    a = split_key_dict(7, ["x", "y", "z"], device="cpu")
    b = split_key_dict(7, ["x", "y", "z"], device="cpu")
    c = split_key_dict(8, ["x", "y", "z"], device="cpu")
    draws = {n: torch.rand(4, generator=g) for n, g in a.items()}
    assert all(torch.equal(draws[n], torch.rand(4, generator=b[n])) for n in a)
    assert not torch.equal(draws["x"], draws["y"]) and not torch.equal(draws["y"], draws["z"])
    assert not torch.equal(draws["x"], torch.rand(4, generator=c["x"]))
    src = torch.Generator().manual_seed(7)
    d, e = split_key_dict(src, ["x"]), split_key_dict(src, ["x"])  # the source advances
    assert not torch.equal(torch.rand(4, generator=d["x"]), torch.rand(4, generator=e["x"]))


def test_set_dtype_and_nan_checks():
    from brancher_torch.config import config, default_dtype, enable_nan_checks, set_dtype
    from brancher_torch.utilities import to_array

    old = config.dtype
    try:
        for spec in ("float64", np.float64, torch.float64):
            set_dtype(spec)
            assert default_dtype() is torch.float64 and to_array(1.5).dtype == torch.float64
        with pytest.raises(ValueError, match="unknown dtype"):
            set_dtype("float7")
    finally:
        set_dtype(old)
    assert default_dtype() is old

    was = torch.is_anomaly_enabled()
    try:
        enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()  # NaN made in the backward pass: raised
        enable_nan_checks(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)
