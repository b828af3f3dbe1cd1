"""Port: whole sampling runs, on the CPU.

Torch and JAX draw different random numbers, so whole runs are compared
statistically: the conjugate posterior against its closed form, and the
logistic-regression posterior mean against the JAX package's ``sample()``
within 5 Monte-Carlo standard errors (MCSE = posterior sd / sqrt(ESS))."""
import jax
import numpy as np
import pytest
import torch

from brancher_tpu.inference import NUTS as JNUTS
from brancher_tpu.inference import sample as jsample
from brancher_tpu.models import logistic_regression_model as j_logreg
from brancher_torch.inference import HMC, NUTS, ChEESHMC, sample
from brancher_torch.models import conjugate_normal_model, logistic_regression_model, make_logreg_data

torch.set_num_threads(2)


def _mean_sd_ess(samples, ess):
    x = np.asarray(samples, np.float64)
    return x.mean(axis=(0, 1)), x.std(axis=(0, 1)), np.asarray(ess, np.float64)


def test_conjugate_matches_closed_form():
    model, info = conjugate_normal_model()
    res = sample(model, kernel=NUTS(max_depth=6), num_samples=600, num_warmup=300,
                 num_chains=8, key=0, device="cpu")
    assert res.diagnostics["fused_family"] == "normal_learned"
    mean, sd, ess = _mean_sd_ess(res.samples["mu"].numpy(), res.diagnostics["ess"]["mu"])
    mcse = sd / np.sqrt(ess)
    assert abs(mean - info["post_mean"]) < 5 * mcse
    # variance: relative standard error ~ sqrt(2 / ESS) (~3% here)
    assert abs(sd**2 / info["post_var"] - 1.0) < 5 * np.sqrt(2.0 / ess)
    assert float(res.diagnostics["r_hat"]["mu"]) < 1.05


def test_logreg_posterior_mean_matches_jax():
    x, y, _ = make_logreg_data(100, 3, seed=1)
    jres = jsample(j_logreg(x, y), kernel=JNUTS(max_depth=4), num_samples=200, num_warmup=150,
                   num_chains=8, key=jax.random.PRNGKey(0), fused_potential="off")
    tres = sample(logistic_regression_model(x, y), kernel=NUTS(max_depth=4), num_samples=200,
                  num_warmup=150, num_chains=8, key=1, device="cpu")
    assert tres.diagnostics["fused_family"] == "bernoulli_logit"
    jm, jsd, jess = _mean_sd_ess(jres.samples["w"], jres.diagnostics["ess"]["w"])
    tm, tsd, tess = _mean_sd_ess(tres.samples["w"].numpy(), tres.diagnostics["ess"]["w"])
    mcse = np.sqrt(jsd**2 / jess + tsd**2 / tess)
    assert np.all(np.abs(tm - jm) < 5 * mcse), (tm, jm, mcse)
    np.testing.assert_allclose(tsd, jsd, rtol=0.2)
    assert np.max(tres.diagnostics["r_hat"]["w"]) < 1.05


def test_fused_and_autodiff_paths_agree():
    x, y, _ = make_logreg_data(80, 2, seed=3)
    model = logistic_regression_model(x, y)
    kw = dict(kernel=NUTS(max_depth=5), num_samples=200, num_warmup=150, num_chains=6, device="cpu")
    fused = sample(model, key=2, **kw)
    auto = sample(model, key=3, fused_potential="off", **kw)
    bf16 = sample(model, key=4, fused_potential="bf16", **kw)
    assert auto.diagnostics["fused_family"] is None
    assert bf16.diagnostics["fused_dtype"] == "bf16" and fused.diagnostics["fused_dtype"] == "f32"
    for other in (auto, bf16):
        a, asd, aess = _mean_sd_ess(fused.samples["w"].numpy(), fused.diagnostics["ess"]["w"])
        b, bsd, bess = _mean_sd_ess(other.samples["w"].numpy(), other.diagnostics["ess"]["w"])
        assert np.all(np.abs(a - b) < 5 * np.sqrt(asd**2 / aess + bsd**2 / bess))
    d = fused.diagnostics
    # one value+grad per leaf, plus the initial one and the step-size probe
    assert d["value_and_grad_calls"] > d["warmup_leapfrog"] + int(fused.stats["num_steps"][0].sum())
    assert d["host_syncs"] >= d["warmup_leapfrog"]
    assert d["sampler_seconds"] > 0


def test_init_strategies_and_options():
    model, _ = conjugate_normal_model()
    kw = dict(kernel=NUTS(max_depth=4), num_samples=20, num_warmup=20, num_chains=3, device="cpu")
    prior = sample(model, init_strategy="prior", key=5, **kw)
    assert prior.samples["mu"].shape == (3, 20)
    fixed = sample(model, init_values={"mu": torch.tensor(1.0)}, key=6, ess_vars=["mu"], **kw)
    assert set(fixed.diagnostics["ess"]) == {"mu"}
    with pytest.raises(ValueError, match="not in collected samples"):
        sample(model, ess_vars=["nope"], key=7, **kw)
    with pytest.raises(ValueError, match="unknown init_strategy"):
        sample(model, init_strategy="median", key=7, **kw)
    assert sample(model, diagnostics_backend="none", key=8, **kw).diagnostics.get("ess") is None


def test_sample_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, _ = conjugate_normal_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample(model, num_samples=5, num_warmup=5, num_chains=2)


@pytest.mark.parametrize("option", [
    {"chain_method": "vmap"}, {"chain_method": "shard_map"}, {"mass": "dense"},
    {"resume_state": {"z": None}}, {"enumerate_discrete": True},
    {"diagnostics_backend": "device"},
], ids=lambda o: next(iter(o)) + "=" + str(next(iter(o.values())))[:8])
def test_unported_options_raise_naming_the_roadmap(option):
    model, _ = conjugate_normal_model()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sample(model, num_samples=5, num_warmup=5, num_chains=2, device="cpu", **option)


def test_fused_leapfrog_under_nuts_warns_and_changes_nothing():
    """As in the JAX package the flag has no effect under NUTS; unlike it,
    sample() says so and reports that the kernel did not run."""
    model, _ = conjugate_normal_model()
    kw = dict(kernel=NUTS(max_depth=4), num_samples=30, num_warmup=30, num_chains=4, key=3,
              device="cpu")
    plain = sample(model, **kw)
    with pytest.warns(UserWarning, match="fused_leapfrog=True was requested"):
        flagged = sample(model, fused_leapfrog=True, **kw)
    assert torch.equal(plain.samples["mu"], flagged.samples["mu"])
    assert flagged.diagnostics["fused_leapfrog"] is False


@pytest.mark.parametrize("kernel", [HMC(num_integration_steps=5, jitter_steps=False),
                                    ChEESHMC(max_leapfrog=6), NUTS(max_depth=3)],
                         ids=["hmc", "chees", "nuts"])
def test_engine_dispatch_and_step_counts(kernel):
    x, y, _ = make_logreg_data(60, 2, seed=5)
    res = sample(logistic_regression_model(x, y), kernel=kernel, num_samples=25, num_warmup=25,
                 num_chains=4, key=4, device="cpu")
    d, steps = res.diagnostics, res.stats["num_steps"]
    assert steps.shape == (4, 25) and d["total_leapfrog_steps"] == int(steps.sum())
    assert ("trajectory_length" in d) == isinstance(kernel, ChEESHMC)
    if isinstance(kernel, HMC):
        assert bool((steps == 5).all()) and d["host_syncs"] == 0
    if isinstance(kernel, ChEESHMC):
        assert int(steps.max()) <= 6 and d["host_syncs"] == 50  # one count read per transition
    # value+grad calls: the initial one, the step-size search, one per leapfrog step
    if not isinstance(kernel, NUTS):
        assert d["value_and_grad_calls"] > int(steps[0].sum())
