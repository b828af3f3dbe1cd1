"""Port parity: ESS and R-hat on a fixed array (brancher_torch vs
brancher_tpu.inference.diagnostics, host variants)."""
import numpy as np
import pytest

import brancher_tpu.inference.diagnostics as JDG
import brancher_torch.inference.diagnostics as TDG


def _chains(shape=(4, 300, 3), phi=0.7, seed=0):
    """AR(1) chains with different offsets: autocorrelated, slightly
    unmixed — a case where every estimator has work to do."""
    rng = np.random.RandomState(seed)
    eps = rng.normal(size=shape)
    x = np.zeros(shape)
    for t in range(1, shape[1]):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    x += 0.2 * np.arange(shape[0]).reshape((-1,) + (1,) * (len(shape) - 1))
    return x.astype(np.float32)


FNS = ["effective_sample_size", "potential_scale_reduction", "rank_normalized_rhat",
       "folded_rhat", "max_rhat"]


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("shape", [(4, 300, 3), (2, 101)], ids=["3d", "2d"])
def test_diagnostic_matches_jax(fn, shape):
    x = _chains(shape)
    ref = getattr(JDG, fn)(x)
    got = getattr(TDG, fn)(x)
    # the same float64 numpy estimator on the same array
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert np.all(np.isfinite(got))


def test_too_few_draws_report_nan():
    x = _chains((3, 3, 2))
    assert np.all(np.isnan(TDG.potential_scale_reduction(x)))
    assert np.all(np.isnan(TDG.effective_sample_size(x[:, :1])))
