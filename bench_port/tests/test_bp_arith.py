"""The benchmark's arithmetic on fixed arrays: ESS and R-hat, the trace's
busy time and idle gaps, operations and bytes, the metric readers, the
reduced-precision products and the check's numbers."""
import numpy as np
import pytest
import torch

from bench_port import check, devtrace, frozen, harness, precision

ROOT = harness.ROOT


def _reader(name):
    return harness.load_module(harness.reader_path(name), f"a_{name}").read


def test_ess_is_capped_and_sees_autocorrelation():
    rng = np.random.default_rng(0)
    iid = rng.normal(size=(4, 1000, 3))
    ess = frozen.effective_sample_size(iid)
    assert ess.shape == (3,) and bool((ess <= 4000.0).all()) and bool((ess > 2500.0).all())
    ar = np.zeros((4, 1000))
    for t in range(1, 1000):
        ar[:, t] = 0.9 * ar[:, t - 1] + rng.normal(size=4)
    assert 100.0 < float(frozen.effective_sample_size(ar)) < 500.0  # about 4000 * 0.1 / 1.9


@pytest.mark.parametrize("shape", [(4, 37, 3), (1, 64, 2), (16, 200, 5), (3, 5, 1)])
def test_frozen_copies_agree_with_the_port(shape):
    from brancher_torch.inference import diagnostics

    rng = np.random.default_rng(sum(shape))
    x = np.cumsum(rng.normal(size=shape), axis=1) * 0.3 + rng.normal(size=shape)
    np.testing.assert_allclose(frozen.effective_sample_size(x).numpy(),
                               diagnostics.effective_sample_size(x), rtol=1e-10)
    np.testing.assert_allclose(frozen.potential_scale_reduction(x).numpy(),
                               diagnostics.potential_scale_reduction(x), rtol=1e-10)


def test_rhat_of_stuck_chains_is_far_above_one():
    rng = np.random.default_rng(1)
    assert check.rhat_max(rng.normal(size=(8, 100, 2))) < 1.05
    stuck = np.repeat(rng.normal(size=(8, 1, 2)), 100, axis=1)
    assert check.rhat_max(stuck) > 1e6  # within-chain variance 0 to rounding


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_time_and_idle_gaps_from_intervals():
    events = [_ev("kernel", "k1", 0.0, 10.0), _ev("kernel", "k2", 5.0, 15.0),
              _ev("gpu_memcpy", "copy", 30.0, 10.0), _ev("kernel", "k1", 60.0, 20.0),
              _ev("cpu_op", "aten::item", 18.0, 14.0), _ev("cpu_op", "outer", 0.0, 100.0),
              _ev("cuda_runtime", "cudaLaunchKernel", 45.0, 2.0)]
    assert devtrace.device_intervals(events) == [(0.0, 20.0), (30.0, 40.0), (60.0, 80.0)]
    busy, window = devtrace.busy(events), 100e-6
    assert busy == pytest.approx(50e-6)
    assert devtrace.top_device_ops(events)[0] == ["k1", pytest.approx(30e-6)]
    gaps = dict((n, s) for n, s in devtrace.idle_gaps(events))
    assert gaps == {"aten::item": pytest.approx(10e-6), "outer": pytest.approx(20e-6)}
    read = _reader("device_idle_share")
    assert read({"trace": {"busy_s": busy, "window_s": window}}) == pytest.approx(50.0)
    assert read({"trace": None}) is None


def test_operations_and_bytes_of_a_call():
    cov = harness.Cell(harness.load_benchmark(), "covtype_logreg.nuts_c1024")
    w = cov.model.work(cov.cfg, 1024, 55)
    assert w["flops"] == 4 * 1024 * 581012 * 55 == 130_890_383_360
    assert w["bytes"] == 4 * (581012 * 55 + 581012 + 2 * 1024 * 55 + 1024)
    b = frozen.bound(w["bytes"], w["flops"], "f32")
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(130_890_383_360 / 67e12 * 1e3)


def test_metric_readers_on_a_fixed_run():
    ctx = {"setup_s": 12.5, "warmup_s": 8.0, "window_s": 10.0, "chains": 4, "draws": 50,
           "calls": [{"sampler_seconds": 4.0, "vg_calls": 300}, {"sampler_seconds": 4.0, "vg_calls": 100}],
           "potential_ms": 2.0,
           "work": {"flops": 67e9, "bytes": 1.0, "dtype": "f32"}, "trace": None}
    want = {"setup_s": 12.5, "warmup_s": 8.0, "draws_per_s": 20.0, "draws_per_s.host": 20.0,
            "sample_overhead_share": 20.0, "grads_per_draw": 8.0, "ms_per_grad": 20.0,
            "potential_ms": 2.0, "potential_roofline": 50.0,
            "step_mfu": 4.0, "device_idle_share": None}
    for name, value in want.items():
        got = _reader(name)(ctx)
        assert got == (None if value is None else pytest.approx(value)), name


def test_reduced_precision_rounding():
    x = torch.tensor([1 + 2**-12, 1 + 3 * 2**-12, -(1 + 3 * 2**-12), 1 + 2**-8])
    assert precision.ROUND["tf32"](x).tolist() == [1.0, 1 + 2**-10, -(1 + 2**-10), 1 + 2**-8]
    assert precision.ROUND["bf16"](x).tolist() == [1.0, 1.0, -1.0, 1 + 2**-7]  # a tie rounds up
    a = torch.randn(8, 5, dtype=torch.float32, requires_grad=True)
    b = torch.randn(5, 3)
    out = precision.matmul(a, b, "tf32")
    (ga,) = torch.autograd.grad(out.sum(), a)
    exact = torch.ones(8, 3) @ b.T
    assert 0 < float((ga - exact).abs().max()) < 1e-2
    assert float((out.detach() - a.detach() @ b).abs().max()) < 1e-2


def test_stein_numbers_of_exact_draws_are_near_zero():
    g = torch.Generator().manual_seed(3)
    m, s = torch.tensor([1.0, -2.0], dtype=torch.float64), torch.tensor([0.5, 3.0], dtype=torch.float64)
    z = m + s * torch.randn(200_000, 2, generator=g, dtype=torch.float64)
    grad = -(z - m) / s**2
    nums = check.stein_numbers(z, grad)
    assert nums["stein_scale"] < 0.02 and nums["stein_shift"] < 0.02
    zs = z + 0.5 * s  # draws shifted by half a standard deviation
    assert check.stein_numbers(zs, -(zs - m) / s**2)["stein_shift"] == pytest.approx(0.5, abs=0.02)
    zw = m + 1.5 * (z - m)  # draws 1.5 times too wide: E[...] = -2.25
    assert check.stein_numbers(zw, -(zw - m) / s**2)["stein_scale"] == pytest.approx(1.25, abs=0.03)


def test_judge_and_seeds():
    ok, out = check.judge({"a": 1.0, "b": 0.5}, {"a": 1.0, "b": 1.0})
    assert ok and list(out) == ["a", "b"] and out["a"] == {"value": 1.0, "limit": 1.0}
    assert not check.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not check.judge({"a": 0.0}, {})[0]
    seed = 2**31 + 5
    assert harness.derive(seed, "rows") == harness.derive(seed, "rows")
    assert harness.derive(seed, "rows") != harness.derive(seed, "call0") < 2**60


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    for name in ("brancher_torch_fake", "jaxfoo", "brancher_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "brancher_tpu", types.ModuleType("brancher_tpu"))
    assert harness.forbidden_modules() == ["brancher_tpu", "jax"]
