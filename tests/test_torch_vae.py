"""Port parity: the VAE (brancher_torch.models.vae against brancher_tpu's).

The ELBO of a small VAE (latent 2, hidden 8, batch 16, obs 12) and its
gradient with respect to every decoder and encoder parameter, at JAX's
params carried across (``bridge.params_to_torch``: flax kernels become
nn.Linear weights) and at JAX's minibatch and noise, within 1e-5 of each
quantity's largest magnitude.  The port's amortised guide reads p's
minibatch draw: a guide that drew its own would give a finite, wrong
ELBO here."""
import jax
import numpy as np
import pytest
import torch

import brancher_tpu.inference.guides as JG
import brancher_tpu.inference.svi as JS
import brancher_tpu.models.vae as JV
import brancher_torch.inference.guides as TG
import brancher_torch.inference.svi as TS
import brancher_torch.models.vae as TV
from brancher_torch.bridge import params_to_torch

torch.set_num_threads(2)

OBS, LATENT, HIDDEN, BATCH, N = 12, 2, 8, 16, 64
RTOL = 1e-5


def _models():
    data = TV.make_vae_data(num_points=N, obs_dim=OBS, true_latent=2, seed=4)
    cfg = (LATENT, HIDDEN, BATCH)
    return JV.vae_model(data, JV.VAEConfig(*cfg)), TV.vae_model(data, TV.VAEConfig(*cfg))


def _tree_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def test_make_vae_data_is_jax_s():
    np.testing.assert_array_equal(TV.make_vae_data(100, 16, seed=2), JV.make_vae_data(100, 16, seed=2))


@pytest.mark.parametrize("n_samples", [1, 3])
def test_fixed_draw_vae_loss_and_grads_match_jax(n_samples):
    (jp, jq), (tp, tq) = _models()
    jc, tc = jp.compiled(), tp.compiled("cpu")
    jguide, tguide = JG.DSLGuide(jq), TG.DSLGuide(tq, device="cpu")
    jparams = {"p": jc.initial_params, "q": jguide.init_params(None)}
    key = jax.random.PRNGKey(5)
    ref_loss, ref_grad = jax.jit(jax.value_and_grad(JS.ReverseKL().make_loss(jc, jguide)),
                                 static_argnums=2)(jparams, key, n_samples)

    # JAX's draws: the loaders from k_data, z's noise from fold_in(k_s, i)
    k_data, k_guide = jax.random.split(key)
    data = jc.sample_subgraph_one(jparams["p"], k_data, tuple(jc.data_loader_names))
    i_z = [v.name for v in jguide.comp.order].index("z")
    eps = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, i_z), (BATCH, LATENT)))
                    for k in jax.random.split(k_guide, n_samples)])
    draws = {"data": params_to_torch(jax.tree.map(np.asarray, data), device="cpu"),
             "noise": {"z": torch.as_tensor(eps)}}

    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    assert sorted(tparams["p"]["decoder__params"]) == [
        "Dense_0.bias", "Dense_0.weight", "Dense_1.bias", "Dense_1.weight"]
    names, leaves = zip(*_tree_leaves(tparams))
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = TS.ReverseKL().make_loss(tc, tguide)(tparams, None, n_samples, draws=draws)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=RTOL)
    grads = torch.autograd.grad(loss, leaves)
    ref = dict(_tree_leaves(params_to_torch(jax.tree.map(np.asarray, ref_grad), device="cpu")))
    assert set(ref) == set(names) and len(names) == 12
    for name, g in zip(names, grads):
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=RTOL * np.abs(r).max(), err_msg=name)


def test_vae_elbo_decreases_and_posterior_samples():
    """tests/test_logreg_vae.py::test_vae_elbo_decreases and
    ::test_vae_posterior_sample_api on the port.  nn.Linear's initial
    weights are not flax's and start the loss nearer its end (about 8,600
    against JAX's 9,000 over the first 100 steps on the CPU), so the last
    100 steps' mean is held below 0.95 of the first 100's, not 0.9."""
    data = TV.make_vae_data(num_points=512, obs_dim=24, true_latent=3, seed=0)
    p_model, q_model = TV.vae_model(data, TV.VAEConfig(latent_dim=3, hidden_dim=16, batch_size=64))
    res = TS.perform_inference(p_model, number_iterations=400, number_samples=2, lr=1e-3, key=0,
                               device="cpu")
    assert np.all(np.isfinite(res.loss_curve))
    assert np.mean(res.loss_curve[-100:]) < 0.95 * np.mean(res.loss_curve[:100])
    assert isinstance(res.guide, TG.DSLGuide) and res.guide.q_model is q_model
    post = p_model.get_posterior_sample_dict(3, key=1, device="cpu")
    assert post["z"].shape == (3, 64, 3) and post["x"].shape == (3, 64, 24)
    # the modules are made under a fixed seed: the same initial params
    again = TV.vae_model(data, TV.VAEConfig(latent_dim=3, hidden_dim=16, batch_size=64))[0]
    w0 = again.compiled("cpu").initial_params["decoder__params"]["Dense_0.weight"]
    p0 = TV.vae_model(data, TV.VAEConfig(latent_dim=3, hidden_dim=16, batch_size=64))[0]
    assert torch.equal(w0, p0.compiled("cpu").initial_params["decoder__params"]["Dense_0.weight"])
