"""Sharded chains and SVI batches on a gloo group of two CPU ranks
(brancher_torch sample(mesh=) and perform_inference(mesh=)).

The group (tests/torch_dist.py, scenarios in tests/torch_dist_scenarios.py)
runs every sharded run once; each test reads one of its outputs.

  * The port against itself with the same numbers: the batched step-size
    probe and a warmup window of vectorized NUTS over two ranks equal the
    unsharded functions over the union of the chains, fed the same momenta
    and leaf draws (``KeyedNutsRandom``); the probe exactly, the window of
    16 transitions (slow window [4, 12) and its mass update) within 1e-4.
    The mean accept probability over two ranks is a mean of two means,
    which rounds otherwise than the mean of eight; NUTS's tree amplifies
    that last bit over the transitions (1e-7 after 10, 6e-5 after 20, a
    different tree after 40), so the window is held short.  The ELBO and
    its gradients at fixed noise over two ranks equal the unsharded ones
    within 1e-5.
  * Statistical checks at the JAX tests' sizes and limits:
    test_vectorized_nuts.py::test_vectorized_sharded,
    test_inference_conjugate.py::test_mcmc_sharded_chains and
    test_logreg_vae.py::test_sharded_elbo_matches_local; dense mass, the
    pipelined engine and ChEES with a mesh against the closed form.
  * Cross-rank: every rank returns the same global result bit for bit,
    and a rerun at the same key is bit-identical
    (test_determinism.py::test_vectorized_nuts_sharded_bit_identical).
"""
import numpy as np
import pytest
import torch

from brancher_torch.inference import perform_inference
from brancher_torch.inference.adaptation import find_reasonable_step_size_batched
from brancher_torch.inference.svi import ReverseKL
from brancher_torch.inference.vectorized_nuts import nuts_batched
from brancher_torch.models import conjugate_normal_model
from brancher_torch.optimizers import set_grads, trainable_copy
from tests.torch_dist import KeyedNutsRandom, assert_same_on_every_rank, gaussian_vg, load, run_group
from tests.torch_dist_scenarios import (
    PROBE_CHAINS, PROBE_SCALES, WINDOW_SEED, WINDOW_WARMUP, probe_inputs, svi_setup,
)

torch.set_num_threads(2)
WORLD = 2


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group("mcmc", WORLD, tmp_path_factory.mktemp("mcmc"))


def outputs(group, name):
    return load(group, name, WORLD)


def truth():
    return conjugate_normal_model()[1]


def test_step_size_probe_equals_unsharded(group):
    z, noise = probe_inputs()
    want = find_reasonable_step_size_batched(gaussian_vg(PROBE_SCALES), torch.as_tensor(z),
                                             torch.ones(3), init_step=1.0,
                                             noise=torch.as_tensor(noise))
    for out in outputs(group, "probe"):
        assert float(out["step"]) == float(want)


def test_warmup_window_equals_unsharded(group):
    z, _ = probe_inputs()
    want = nuts_batched(gaussian_vg(PROBE_SCALES), torch.as_tensor(z), WINDOW_WARMUP, 3,
                        rng=KeyedNutsRandom(WINDOW_SEED, PROBE_CHAINS), max_depth=5,
                        init_step_size=0.5)
    assert not torch.equal(want.inv_mass, torch.ones(3))  # the window's mass update ran
    for out in outputs(group, "warmup_window"):
        np.testing.assert_allclose(float(out["step_size"]), float(want.step_size), rtol=1e-4)
        np.testing.assert_allclose(out["inv_mass"].numpy(), want.inv_mass.numpy(), rtol=1e-4)
        np.testing.assert_allclose(out["samples"].numpy(), want.samples.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_vectorized_sharded(group):
    for out in outputs(group, "nuts_conjugate"):
        mu = out["mu"]
        assert mu.shape[:2] == (16, 400) and out["num_steps"].shape == (16, 400)
        assert abs(float(mu.mean()) - truth()["post_mean"]) < 0.06
        assert out["local_vg_calls"] > 0 and out["warmup_leapfrog"] > 0


def test_mcmc_sharded_chains(group):
    for out in outputs(group, "hmc_shard_map"):
        assert out["mu"].shape[:2] == (8, 400)
        assert out["step_size"].shape == (8,)
        assert abs(float(out["mu"].mean()) - truth()["post_mean"]) < 0.07


def test_vectorized_nuts_sharded_bit_identical(group):
    for out in outputs(group, "determinism"):
        assert torch.equal(out["w1"], out["w2"])
        assert out["w1"].shape[:2] == (8, 60)
        assert out["family"] == "bernoulli_logit"


@pytest.mark.parametrize("mode", ["dense", "pipelined", "chees"])
def test_modes_with_a_mesh_match_the_closed_form(group, mode):
    t = truth()
    for out in outputs(group, "modes"):
        mu = out[mode]
        assert mu.shape[:2] == (8, 300)
        assert abs(float(mu.mean()) - t["post_mean"]) < 0.07
        assert abs(float(mu.var()) - t["post_var"]) < 0.03
        if mode == "dense":
            assert out["dense_inv_mass"].shape == (1, 1) and out["dense_stage_a_draws"] == 200
        if mode == "chees":
            assert float(out["chees_trajectory"]) > 0


def test_sharded_elbo_loss_and_grads_equal_unsharded(group):
    _, comp, guide, params0, noise = svi_setup()
    params, leaves = trainable_copy(params0)
    loss = ReverseKL().make_loss(comp, guide)(params, None, 16, draws={"noise": torch.as_tensor(noise)})
    set_grads(loss, leaves)
    for out in outputs(group, "svi_grads"):
        np.testing.assert_allclose(float(out["loss"]), float(loss.detach()), rtol=1e-5)
        np.testing.assert_allclose(out["loc_grad"].numpy(), params["q"]["loc"].grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["log_scale_grad"].numpy(),
                                   params["q"]["log_scale"].grad.numpy(), rtol=1e-5, atol=1e-5)


def test_sharded_elbo_matches_local(group):
    model = svi_setup()[0]
    res = perform_inference(model, number_iterations=500, number_samples=16, lr=0.05, key=0,
                            device="cpu")
    for out in outputs(group, "svi_run"):
        np.testing.assert_allclose(out["loc"].numpy(), res.params["q"]["loc"].numpy(), atol=0.15)
        assert out["loss_curve"].shape == (500,) and bool(torch.isfinite(out["loss_curve"]).all())


@pytest.mark.parametrize("name", ["probe", "warmup_window", "nuts_conjugate", "hmc_shard_map",
                                  "determinism", "modes", "svi_grads", "svi_run"])
def test_every_rank_returns_the_same_result(group, name):
    assert_same_on_every_rank(outputs(group, name))
