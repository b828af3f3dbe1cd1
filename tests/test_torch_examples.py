"""The port's examples (``examples/torch/``) against the JAX package's
(``examples/``) at a small size on the CPU.

Each example's ``main(device="cpu", ...)`` runs at the size below; the JAX
example's calls are written out here with ``brancher_tpu`` at the same size
and data.  The two use different random streams, so they are held within
Monte-Carlo error of each other (NUTS: ``K_MCSE`` times the combined
standard error of the two means, from each run's ESS), and each is held
against the example's own truth: the closed form (01), the true weights
(02), the least-squares fit (03), the Kalman filter (04), a falling loss
(05, 06) and Stan's posterior (07).
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples" / "torch"
# two means from independent runs agree within this many combined standard
# errors (each sd / sqrt(ESS))
K_MCSE = 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are many small operations, which
    threads only slow down when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_example(stem):
    path = next(EXAMPLES.glob(f"{stem}_*.py"))
    spec = importlib.util.spec_from_file_location(f"torch_example_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mcse(sd, ess):
    return np.asarray(sd) / np.sqrt(np.asarray(ess))


def _within_mcse(a, sd_a, ess_a, b, sd_b, ess_b, k=K_MCSE):
    se = np.hypot(_mcse(sd_a, ess_a), _mcse(sd_b, ess_b))
    assert np.all(np.abs(np.asarray(a) - np.asarray(b)) <= k * se), (a, b, se)


def test_example_01_conjugate_gaussian():
    from brancher_tpu import NormalVariable, ProbabilisticModel
    from brancher_tpu.inference import NUTS, perform_inference, sample

    sizes = dict(svi_iterations=600, num_samples=300, num_warmup=300, num_chains=4)
    out = load_example("01").main(device="cpu", **sizes)
    # the closed form: SVI within 0.05 of the mean and 25 % of the variance,
    # NUTS within 5 MCSE
    assert abs(out["svi_mean"] - out["analytic_mean"]) < 0.05
    assert abs(out["svi_var"] / out["analytic_var"] - 1) < 0.25
    _within_mcse(out["nuts_mean"], np.sqrt(out["nuts_var"]), out["min_ess"],
                 out["analytic_mean"], 0.0, 1.0)
    assert abs(out["nuts_var"] / out["analytic_var"] - 1) < 0.15
    assert out["r_hat"] < 1.02 and out["fused_family"] == "normal_learned"

    data = np.random.RandomState(0).normal(1.5, 1.0, size=50).astype(np.float32)
    mu = NormalVariable(0.0, 2.0, "mu")
    x = NormalVariable(mu, 1.0, "x")
    x.observe(data)
    model = ProbabilisticModel([x])
    res = perform_inference(model, number_iterations=600, number_samples=32, lr=0.02,
                            key=jax.random.PRNGKey(0))
    loc, _ = res.guide.posterior_moments(res.params["q"])
    mcmc = sample(model, kernel=NUTS(), num_samples=300, num_warmup=300, num_chains=4,
                  key=jax.random.PRNGKey(0))
    mu_j = np.asarray(mcmc.samples["mu"])
    assert abs(out["svi_mean"] - float(loc[0])) < 0.05
    _within_mcse(out["nuts_mean"], np.sqrt(out["nuts_var"]), out["min_ess"], mu_j.mean(),
                 mu_j.std(), float(np.min(mcmc.diagnostics["ess"]["mu"])))


def test_example_02_bayesian_logistic_regression():
    from brancher_tpu.inference import NUTS, sample
    from brancher_tpu.models.logistic_regression import (logistic_regression_model,
                                                         make_logreg_data)

    # the example's data (N=1000, D=16), fewer chains, draws and SVI steps;
    # at D=16 NUTS fills its trees (JAX's run too), so the depth is cut to 6
    sizes = dict(num_points=1000, dim=16, num_samples=100, num_warmup=150, num_chains=8,
                 max_depth=6, svi_iterations=800, batch_size=128)
    out = load_example("02").main(device="cpu", **sizes)
    # the example's own limits: the posterior mean tracks the true weights
    # and the minibatch SVI mean tracks NUTS's
    assert out["corr_nuts_truth"] > 0.9 and out["corr_svi_nuts"] > 0.9
    assert out["max_r_hat"] < 1.05 and out["fused_family"] == "bernoulli_logit"

    x, y, _ = make_logreg_data(num_points=1000, dim=16)
    res = sample(logistic_regression_model(x, y), kernel=NUTS(max_depth=6), num_samples=100,
                 num_warmup=150, num_chains=8, key=jax.random.PRNGKey(0))
    w_j = np.asarray(res.samples["w"]).reshape(-1, 16)
    _within_mcse(out["w_post"], out["w_sd"], out["w_ess"], w_j.mean(0), w_j.std(0),
                 np.asarray(res.diagnostics["ess"]["w"]))


def test_example_03_autoregressive_timeseries():
    from brancher_tpu.inference import NUTS, sample
    from brancher_tpu.models.autoregressive import ar_model, make_ar_data

    sizes = dict(length=400, num_samples=200, num_warmup=200, num_chains=4, max_depth=6)
    out = load_example("03").main(device="cpu", **sizes)
    # the least-squares fit: within 4 posterior sds (the prior's pull is
    # negligible at T=400)
    assert np.all(np.abs(out["coeffs"] - out["lsq_coeffs"]) < 4 * out["coeffs_sd"])
    assert abs(out["noise_scale"] - out["lsq_noise"]) < 0.02
    assert out["fused_family"] == "normal_learned" and out["max_r_hat"] < 1.05

    data = make_ar_data(length=400, coeffs=(0.5, 0.2), noise=0.3)
    res = sample(ar_model(data, order=2), kernel=NUTS(max_depth=6), num_samples=200,
                 num_warmup=200, num_chains=4, key=jax.random.PRNGKey(0))
    c_j = np.asarray(res.samples["coeffs"]).reshape(-1, 2)
    _within_mcse(out["coeffs"], out["coeffs_sd"], out["coeffs_ess"], c_j.mean(0), c_j.std(0),
                 np.asarray(res.diagnostics["ess"]["coeffs"]))


def test_example_04_state_space_smc():
    import jax.numpy as jnp
    from brancher_tpu.inference.smc import smc_sample
    from brancher_tpu.models.state_space import LGSSMParams, lgssm_state_space, make_lgssm_data

    # the example's own size: T=200, 8192 particles (under a second here)
    out = load_example("04").main(device="cpu")
    # the Kalman filter's log marginal within 0.5 nats, its filter means
    # within 0.1
    assert abs(out["smc_log_marginal"] - out["kalman_log_marginal"]) < 0.5
    assert out["max_filter_mean_error"] < 0.1 and out["min_ess"] > 200

    params = LGSSMParams(a=0.9, q=0.3, c=1.0, r=0.5)
    _, ys = make_lgssm_data(length=200, params=params)
    res = smc_sample(lgssm_state_space(params), jnp.asarray(ys), num_particles=8192,
                     key=jax.random.PRNGKey(0))
    assert abs(out["smc_log_marginal"] - float(res.log_marginal)) < 0.5


def test_example_05_vae():
    from brancher_tpu.inference import perform_inference
    from brancher_tpu.models.vae import VAEConfig, make_vae_data, vae_model

    sizes = dict(num_points=512, obs_dim=32, latent_dim=4, hidden_dim=32, batch_size=64,
                 iterations=300)
    out = load_example("05").main(device="cpu", **sizes)
    # the loss falls: the last tenth's mean under 90 % of the first tenth's
    assert out["loss_last_tenth_mean"] < 0.9 * out["loss_first_tenth_mean"]
    assert out["reconstruction_shape"] == (1, 64, 32)

    data = make_vae_data(num_points=512, obs_dim=32, true_latent=4)
    p, _ = vae_model(data, VAEConfig(latent_dim=4, hidden_dim=32, batch_size=64))
    res = perform_inference(p, number_iterations=300, number_samples=4, lr=1e-3,
                            key=jax.random.PRNGKey(0))
    curve = np.asarray(res.loss_curve)
    # the same data and size: the two trained losses within 10 % (their
    # networks start from different random weights)
    assert abs(out["loss_last_tenth_mean"] / curve[-30:].mean() - 1) < 0.1


def test_example_06_softmax_classification():
    pytest.importorskip("sklearn")
    import brancher_tpu.functions as BF
    from brancher_tpu import (CategoricalVariable, DeterministicVariable, EmpiricalVariable,
                              ProbabilisticModel, RandomIndices)
    from brancher_tpu.inference import MaximumLikelihood, perform_inference

    mod = load_example("06")
    out = mod.main(device="cpu", iterations=300)
    assert out["nll_last"] < 0.1 * out["nll_first"] and out["train_accuracy"] > 0.9

    x_all, y_all = mod.load_data()
    n, d, k = x_all.shape[0], x_all.shape[1], 10
    idx = RandomIndices(n, 256, "idx")
    xb = EmpiricalVariable(x_all, name="xb", indices=idx)
    yb = EmpiricalVariable(y_all, name="yb", indices=idx)
    w = DeterministicVariable(np.zeros((d, k), np.float32), "w", learnable=True)
    b = DeterministicVariable(np.zeros(k, np.float32), "b", learnable=True)
    y = CategoricalVariable(logits=BF.matmul(xb, w) + b, name="y", log_prob_scale=n / 256.0)
    y.observe(yb)
    res = perform_inference(ProbabilisticModel([y]), number_iterations=300, number_samples=1,
                            lr=0.05, inference_method=MaximumLikelihood(),
                            key=jax.random.PRNGKey(0))
    pred = (x_all @ np.asarray(res.params["p"]["w"]) + np.asarray(res.params["p"]["b"])).argmax(-1)
    # the same first loss (zero weights: log 10 per point, scaled), and
    # train accuracies within 2 points
    assert abs(out["nll_first"] / float(res.loss_curve[0]) - 1) < 1e-5
    assert abs(out["train_accuracy"] - float((pred == y_all).mean())) < 0.02


def test_example_07_eight_schools():
    from brancher_tpu.inference import NUTS, sample

    mod = load_example("07")
    out = mod.main(device="cpu", num_samples=400, num_warmup=400, num_chains=4)
    # Stan's posterior (mu 4.4 +- 3.3, tau 3.6 +- 3.2) within 5 MCSE
    _within_mcse(out["mu_mean"], out["mu_sd"], out["mu_ess"], mod.STAN_MU, 0.0, 1.0)
    _within_mcse(out["tau_mean"], out["tau_sd"], out["tau_ess"], mod.STAN_TAU, 0.0, 1.0)
    assert out["fused_family"] is None and out["theta_mean"].shape == (8,)

    import brancher_tpu as BJ
    mu = BJ.NormalVariable(0.0, 5.0, "mu")
    tau = BJ.HalfCauchyVariable(5.0, "tau")
    raw = BJ.NormalVariable(np.zeros(8, np.float32), np.ones(8, np.float32), "theta_raw")
    theta = BJ.DeterministicVariable(mu + tau * raw, "theta")
    y = BJ.NormalVariable(theta, mod.SIGMA, "y")
    y.observe(mod.Y_OBS)
    res = sample(BJ.ProbabilisticModel([y]), kernel=NUTS(max_depth=8), num_samples=400,
                 num_warmup=400, num_chains=4, key=jax.random.PRNGKey(0))
    for name in ("mu", "tau"):
        s = np.asarray(res.samples[name])
        _within_mcse(out[f"{name}_mean"], out[f"{name}_sd"], out[f"{name}_ess"], s.mean(),
                     s.std(), float(res.diagnostics["ess"][name]))
