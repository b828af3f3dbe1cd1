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


DEVICE_CASES = {  # name: (chains array, max_lag)
    "ar07": (_chains((4, 300, 3)), 256),
    "2d": (_chains((2, 101)), 256),
    "short_lag": (_chains((4, 300, 3)), 16),  # Geyer's sequence cut by max_lag: the tail guard
    "slow_mixing": (_chains((2, 1200, 2), phi=0.995), 256),
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_diagnostics_match_jax(case):
    """effective_sample_size_device / potential_scale_reduction_device
    against JAX's on the same float32 array: 1e-5 relative (f32 lag sums
    in two libraries)."""
    import torch

    x, max_lag = DEVICE_CASES[case]
    ess_ref = np.asarray(JDG.effective_sample_size_device(x, max_lag=max_lag))
    ess = TDG.effective_sample_size_device(torch.as_tensor(x), max_lag=max_lag)
    assert ess.dtype == torch.float32 and tuple(ess.shape) == x.shape[2:]
    np.testing.assert_allclose(ess.numpy(), ess_ref, rtol=1e-5)
    rhat_ref = np.asarray(JDG.potential_scale_reduction_device(x))
    np.testing.assert_allclose(TDG.potential_scale_reduction_device(torch.as_tensor(x)).numpy(),
                               rhat_ref, rtol=1e-5)
    assert np.all(np.isfinite(ess_ref))
    if case == "slow_mixing":  # the host estimator (all lags) agrees within 5 %
        np.testing.assert_allclose(ess.numpy(), TDG.effective_sample_size(x), rtol=0.05)


def test_device_diagnostics_too_few_draws_report_nan():
    import torch

    x = torch.as_tensor(_chains((3, 3, 2)))
    assert torch.isnan(TDG.potential_scale_reduction_device(x)).all()
    assert torch.isnan(TDG.effective_sample_size_device(x[:, :1])).all()
    # integer samples are read as float32
    assert TDG.effective_sample_size_device(torch.ones((2, 10), dtype=torch.int32) * torch.arange(10)).dtype \
        == torch.float32


@pytest.mark.parametrize("backend", ["host", "device", "auto"])
def test_sample_diagnostics_backend(backend):
    """sample(diagnostics_backend=...) on the CPU: "auto" is the host there
    (JAX's rule: the device only for more than 16 MB on an accelerator);
    the device ESS is within 5 % of the host's, R-hat within 1e-3."""
    import torch
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.models import conjugate_normal_model

    torch.set_num_threads(2)
    model, _ = conjugate_normal_model()
    kw = dict(kernel=NUTS(max_depth=5), num_samples=300, num_warmup=100, num_chains=4, key=3,
              device="cpu")
    res = sample(model, diagnostics_backend=backend, **kw)
    assert res.diagnostics["diagnostics_backend"] == ("host" if backend == "auto" else backend)
    assert isinstance(res.diagnostics["ess"]["mu"], np.ndarray)
    host = TDG.effective_sample_size(res.samples["mu"].numpy())
    np.testing.assert_allclose(res.diagnostics["ess"]["mu"], host, rtol=0.05)
    np.testing.assert_allclose(res.diagnostics["r_hat"]["mu"],
                               TDG.potential_scale_reduction(res.samples["mu"].numpy()), atol=1e-3)
