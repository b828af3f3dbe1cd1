"""Port parity: WAIC and PSIS-LOO (brancher_torch.model_comparison against
brancher_tpu's).  The pointwise log-likelihood matrix is evaluated at JAX's
own MCMC draws, fed to both packages as a dict; the statistics are the
same float64 numpy arithmetic, so they agree to rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu as BJ
import brancher_tpu.inference as JI
import brancher_tpu.model_comparison as JM
import brancher_torch as BT
import brancher_torch.model_comparison as TM

torch.set_num_threads(2)

# the matrix: f32 log-densities in two libraries, within 1e-5 of the larger
# of 1 and its largest magnitude; the statistics of one matrix: float64
# numpy in both, so 1e-9 relative (only the matrices' f32 rounding differs)
RTOL_MATRIX = 1e-5
RTOL_STATS = 1e-9


def _data(n=40, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, size=n).astype(np.float32)
    y = (1.5 * x + 0.5 + 0.6 * rng.normal(size=n)).astype(np.float32)
    return x, y


def _linear(pkg, x, y, mask=None):
    a = pkg.NormalVariable(0.0, 3.0, "a")
    b = pkg.NormalVariable(0.0, 3.0, "b")
    obs = pkg.NormalVariable(a * x + b, 0.6, "y")
    obs.observe(y)
    if mask is not None:  # missing data, as observe_timeseries sets it
        obs.log_prob_mask = mask
    return pkg.ProbabilisticModel([obs])


def _mean_only(pkg, y):
    b = pkg.NormalVariable(0.0, 3.0, "b")
    obs = pkg.NormalVariable(b * np.ones(len(y), np.float32), 0.6, "y")
    obs.observe(y)
    return pkg.ProbabilisticModel([obs])


@pytest.fixture(scope="module")
def jax_draws():
    """JAX's own NUTS draws of the linear model and the mean-only model."""
    x, y = _data()
    out = {}
    for name, model in (("linear", _linear(BJ, x, y)), ("mean_only", _mean_only(BJ, y))):
        res = JI.sample(model, kernel=JI.NUTS(max_depth=5), num_samples=150, num_warmup=150,
                        num_chains=2, key=jax.random.PRNGKey(0))
        out[name] = {k: np.asarray(res.samples[k]) for k in ("a", "b") if k in res.samples}
    return out


def _close(got, ref, rtol):
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0, atol=rtol * scale)


def test_pointwise_matrix_at_jax_draws_matches(jax_draws):
    x, y = _data()
    draws = jax_draws["linear"]
    ref = JM.pointwise_log_likelihood(_linear(BJ, x, y), draws, max_draws=100)
    got = TM.pointwise_log_likelihood(_linear(BT, x, y), draws, max_draws=100, device="cpu")
    assert got.shape == ref.shape == (100, len(y)) and got.dtype == np.float64
    _close(got, ref, RTOL_MATRIX)
    # the compiled model's pointwise terms sum to its log-likelihood
    comp = _linear(BT, x, y).compiled("cpu")
    vals = {k: torch.as_tensor(v[0, 0]) for k, v in draws.items()}
    pls = comp.pointwise_log_likelihood(comp.initial_params, vals)
    np.testing.assert_allclose(float(sum(v.sum() for v in pls.values())),
                               float(comp.log_likelihood_one(comp.initial_params, vals)), rtol=1e-6)


def test_waic_loo_and_compare_match_jax_on_the_same_draws(jax_draws):
    x, y = _data()
    results = {}
    for name, jm, tm in (("linear", _linear(BJ, x, y), _linear(BT, x, y)),
                         ("mean-only", _mean_only(BJ, y), _mean_only(BT, y))):
        draws = jax_draws["linear" if name == "linear" else "mean_only"]
        for fn in ("waic", "loo"):
            ref = getattr(JM, fn)(jm, draws)
            got = getattr(TM, fn)(tm, draws, device="cpu")
            assert got.method == ref.method
            for field in ("elpd", "se", "p_eff", "deviance"):
                _close(getattr(got, field), getattr(ref, field), RTOL_MATRIX)
            _close(got.pointwise, ref.pointwise, RTOL_MATRIX)
            if fn == "loo":
                # the Pareto k-hats: the same fit on matrices that differ in
                # their last f32 bits
                np.testing.assert_allclose(got.pareto_k, ref.pareto_k, atol=1e-3)
                results[name] = (got, ref)
    table_t = TM.compare({k: v[0] for k, v in results.items()})
    table_j = JM.compare({k: v[1] for k, v in results.items()})
    assert table_t == table_j
    assert table_t.splitlines()[1].startswith("linear")


def test_statistics_of_one_matrix_are_jax_arithmetic():
    """The host halves alone: the same [S, N] matrix through both packages'
    PSIS and WAIC internals (float64 numpy in both)."""
    rng = np.random.RandomState(3)
    ll = rng.normal(-1.0, 0.4, size=(400, 25)) + rng.standard_t(3, size=(400, 25)) * 0.05
    e_t, k_t = TM._psis_elpd(ll)
    e_j, k_j = JM._psis_elpd(ll)
    np.testing.assert_allclose(e_t, e_j, rtol=RTOL_STATS)
    np.testing.assert_allclose(k_t, k_j, rtol=RTOL_STATS)
    for fn in ("_logmeanexp",):
        np.testing.assert_allclose(getattr(TM, fn)(ll, axis=0), getattr(JM, fn)(ll, axis=0),
                                   rtol=RTOL_STATS)


def test_masked_points_are_dropped(jax_draws):
    x, y = _data()
    mask = np.ones(len(y), np.float32)
    mask[[3, 7, 20]] = 0.0
    draws = jax_draws["linear"]
    ref = JM.pointwise_log_likelihood(_linear(BJ, x, y, mask), draws, max_draws=100)
    got = TM.pointwise_log_likelihood(_linear(BT, x, y, torch.as_tensor(mask)), draws,
                                      max_draws=100, device="cpu")
    assert got.shape == ref.shape == (100, len(y) - 3)
    _close(got, ref, RTOL_MATRIX)
    full = TM.pointwise_log_likelihood(_linear(BT, x, y), draws, max_draws=100, device="cpu")
    np.testing.assert_allclose(got, full[:, mask != 0], rtol=1e-6)


def test_given_conditions_the_walk(jax_draws):
    x, y = _data()
    draws = {"a": jax_draws["linear"]["a"]}
    given = {"b": np.float32(0.4)}
    ref = JM.waic(_linear(BJ, x, y), draws, given={k: jnp.asarray(v) for k, v in given.items()})
    got = TM.waic(_linear(BT, x, y), draws, given=given, device="cpu")
    _close(got.elpd, ref.elpd, RTOL_MATRIX)
    _close(got.pointwise, ref.pointwise, RTOL_MATRIX)
    free = TM.waic(_linear(BT, x, y), jax_draws["linear"], device="cpu")
    assert abs(free.elpd - got.elpd) > 1e-3  # b pinned is another model


def test_no_latent_samples_raises():
    x, y = _data()
    with pytest.raises(ValueError, match="no continuous latent"):
        TM.pointwise_log_likelihood(_linear(BT, x, y), {"c": np.zeros((1, 3))}, device="cpu")
