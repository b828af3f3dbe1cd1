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


def test_flax_variables_become_module_params():
    """A flax module's variables cross as the port's module params: kernel
    [in, out] -> weight [out, in], nested layer names joined by "."."""
    from brancher_torch.bridge import flax_to_module_params

    rng = np.random.RandomState(0)
    k0, k1 = rng.normal(size=(3, 5)), rng.normal(size=(5, 2))
    variables = {"params": {"Dense_0": {"kernel": k0, "bias": np.arange(5.0)},
                            "Dense_1": {"kernel": k1, "bias": np.zeros(2)}}}
    out = flax_to_module_params(variables, device="cpu")
    assert sorted(out) == ["Dense_0.bias", "Dense_0.weight", "Dense_1.bias", "Dense_1.weight"]
    np.testing.assert_array_equal(out["Dense_0.weight"].numpy(), k0.T)
    np.testing.assert_array_equal(out["Dense_1.bias"].numpy(), np.zeros(2))
    from brancher_torch.models.vae import MLP

    net = MLP(3, 5, 2).double()
    x = torch.as_tensor(rng.normal(size=(4, 3)))
    got = torch.func.functional_call(net, out, (x,))
    ref = np.maximum(x.numpy() @ k0 + np.arange(5.0), 0.0) @ k1
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-12)


def test_whole_vae_opt_params_cross_in_one_call():
    """params_to_torch carries a JAX VAE's {"p": ..., "q": ...} (flax params
    of the decoder and both encoders) into the port's module params."""
    import jax

    from brancher_tpu.models.vae import VAEConfig, make_vae_data, vae_model
    import brancher_torch.models.vae as TV

    data = make_vae_data(32, 6, seed=0)
    jp, jq = vae_model(data, VAEConfig(latent_dim=2, hidden_dim=4, batch_size=8))
    opt_params = jax.tree.map(np.asarray, {"p": jp.compiled().initial_params,
                                           "q": jq.compiled().initial_params})
    out = params_to_torch(opt_params, device="cpu")
    tp, tq = TV.vae_model(data, TV.VAEConfig(latent_dim=2, hidden_dim=4, batch_size=8))
    for side, model in (("p", tp), ("q", tq)):
        ref = model.compiled("cpu").initial_params
        assert sorted(out[side]) == sorted(ref)
        for name, mp in ref.items():
            assert {k: v.shape for k, v in out[side][name].items()} == {k: v.shape for k, v in mp.items()}
    np.testing.assert_array_equal(out["p"]["decoder__params"]["Dense_1.weight"].numpy(),
                                  opt_params["p"]["decoder__params"]["params"]["Dense_1"]["kernel"].T)
