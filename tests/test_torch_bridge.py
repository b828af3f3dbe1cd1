"""The bridge carries the JAX package's state (as numpy) into the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu as BJ
import brancher_torch as BT
from brancher_torch.bridge import params_to_torch, sampler_state_to_torch, to_tensor


def test_params_and_sampler_state_arrive_on_the_device():
    params = {"a": np.arange(3, dtype=np.float32), "net": {"w": np.ones((2, 2), np.float64)},
              "k": np.array([1, 2], np.int32)}
    out = params_to_torch(params, device="cpu")
    assert out["a"].dtype == torch.float32 and out["net"]["w"].dtype == torch.float64
    assert out["k"].dtype == torch.int32
    np.testing.assert_array_equal(out["net"]["w"].numpy(), params["net"]["w"])
    state = sampler_state_to_torch({"z": np.zeros((4, 3)), "step_size": np.float32(0.1),
                                    "inv_mass": np.ones(3)}, device="cpu")
    assert state["z"].shape == (4, 3) and state["z"].dtype == torch.float32
    assert float(state["step_size"]) == pytest.approx(0.1)


def test_learnable_leaf_params_drive_the_same_density():
    """A learnable deterministic leaf lives in ``params``: the JAX value,
    bridged, gives the port the same log-density."""
    def build(pkg):
        s = pkg.DeterministicVariable(np.float32(0.5), "s", learnable=True)
        x = pkg.NormalVariable(0.0, s, "x")
        x.observe(np.array([0.1, -0.4, 0.3], np.float32))
        mu = pkg.NormalVariable(0.0, 1.0, "mu")
        return pkg.ProbabilisticModel([x, mu])

    jc = build(BJ).compiled()
    tc = build(BT).compiled(device="cpu")
    jparams = {"s": jnp.asarray(1.7, jnp.float32)}
    tparams = params_to_torch({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    ref = jc.log_density_z(jparams, {"mu": jnp.asarray(0.2)})
    got = tc.log_density_z(tparams, {"mu": torch.tensor(0.2)})
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
    assert float(tc.log_density_z(tc.initial_params, {"mu": torch.tensor(0.2)})) != pytest.approx(float(got))


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        to_tensor(np.zeros(2))
