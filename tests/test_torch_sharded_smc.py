"""Sharded particle methods on gloo groups of two and four CPU ranks
(brancher_torch smc_sample(mesh=), island_particle_filter,
StreamingSMC(mesh=) and pmmh_sample(mesh=)).

The groups (tests/torch_dist.py, scenarios in tests/torch_dist_scenarios.py)
run every sharded run once; each test reads one of their outputs.

  * The port against itself with the same numbers, at 2 and 4 ranks: rank
    r is fed its rows of a single-device run's particle normals and the
    shared resampling uniforms (as tests/test_torch_smc.py feeds JAX's);
    the sharded filter then equals the port's single-device
    ``particle_filter`` within 1e-5 (its log-marginal, computed on the
    gathered weights, to the bit), with exchange "ppermute" and "gather"
    equal bit for bit; the island filter equals the log-mean-exp of n
    single-device filters of P / n particles fed the islands' numbers;
    the streaming filter with a mesh equals it without one.
  * Statistical checks at the JAX tests' sizes and limits (two ranks; four
    for shard="both"): test_smc.py::test_sharded_particle_filter_matches_kalman,
    ::test_island_particle_filter_matches_kalman and
    ::test_streaming_filter_sharded_matches_kalman; test_pmmh.py::
    test_pmmh_sharded_chains, ::test_pmmh_sharded_particles and
    ::test_pmmh_sharded_both_2d_mesh.
  * Every rank returns the same global result bit for bit.
"""
import math

import numpy as np
import pytest
import torch

from brancher_torch.inference.smc import particle_filter
from brancher_torch.models import LGSSMParams, kalman_filter, make_lgssm_data
from tests.test_pmmh import _kalman_loglik_grid
from tests.torch_dist import (
    assert_same_on_every_rank, filter_numbers, load, particle_replays, replay_lgssm, run_group,
)
from tests.torch_dist_scenarios import FILTER_P, FILTER_T, filter_ys, island_numbers, stream

torch.set_num_threads(2)
WORLDS = [2, 4]


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    return run_group("smc", 2, tmp_path_factory.mktemp("smc2"))


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    return run_group("smc", 4, tmp_path_factory.mktemp("smc4"))


def outputs(request, world, name):
    return load(request.getfixturevalue(f"group{world}"), name, world)


def single_filter(normals, uniforms, p=FILTER_P, t_len=FILTER_T):
    own, shared = particle_replays(normals[:t_len], uniforms[:t_len - 1])
    res = particle_filter(replay_lgssm(own), filter_ys()[:t_len], p, device="cpu", rng=shared)
    assert own.done() and shared.done()
    return res


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("exchange", ["ring", "gather"])
def test_sharded_filter_equals_single_device(request, world, exchange):
    want = single_filter(*filter_numbers(FILTER_P, FILTER_T, seed=3))
    assert float(want.ess_history.min()) < 0.5 * FILTER_P  # resampling fired
    for out in outputs(request, world, f"filter_{exchange}"):
        assert float(out["log_ml"]) == float(want.log_marginal)
        np.testing.assert_allclose(out["means"].numpy(), want.filter_means.numpy(), atol=1e-5)
        np.testing.assert_allclose(out["ess"].numpy(), want.ess_history.numpy(), rtol=1e-5)
        np.testing.assert_array_equal(out["particles"].numpy(), want.particles.numpy())
        np.testing.assert_allclose(out["weights"].numpy(), want.weights.numpy(), atol=1e-6)
        # the ring reads its predicate once a step; the gather path never
        assert out["syncs"] == (FILTER_T - 1 if exchange == "ring" else 0)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_equals_gather_bit_for_bit(request, world):
    ring = outputs(request, world, "filter_ring")
    gather = outputs(request, world, "filter_gather")
    for a, b in zip(ring, gather):
        for k in ("log_ml", "means", "ess", "particles", "weights"):
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("world", WORLDS)
def test_island_filter_is_the_log_mean_exp_of_single_filters(request, world):
    lp = FILTER_P // world
    full = [single_filter(*island_numbers(world, r), p=lp) for r in range(world)]
    # each island's running log-marginal at every step, from its prefixes
    running = np.array([[float(single_filter(*island_numbers(world, r), p=lp, t_len=t + 1)
                               .log_marginal) for t in range(1, FILTER_T)] for r in range(world)])
    lme = np.log(np.mean(np.exp(running - running.max(0)), 0)) + running.max(0)
    weights = np.exp(running - lme) / world  # [n, T - 1]
    means = np.stack([f.filter_means.numpy() for f in full])  # [n, T]
    want_means = np.concatenate([[means[:, 0].mean()], (weights * means[:, 1:]).sum(0)])
    want_ess = np.stack([f.ess_history.numpy() for f in full]).sum(0)
    for out in outputs(request, world, "island"):
        np.testing.assert_allclose(float(out["log_ml"]), lme[-1], atol=1e-5)
        np.testing.assert_allclose(out["means"].numpy(), want_means, atol=1e-5)
        np.testing.assert_allclose(out["ess"].numpy(), want_ess, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_streaming_with_a_mesh_equals_without(request, world):
    own, shared = particle_replays(*filter_numbers(FILTER_P, FILTER_T, seed=7))
    want = stream(replay_lgssm(own), shared)
    assert own.done() and shared.done()
    for out in outputs(request, world, "streaming"):
        assert float(out["log_ml"]) == float(want["log_ml"])
        assert torch.equal(out["times"], want["times"])
        assert torch.equal(out["tail_times"], want["tail_times"])
        for k in ("mean0", "means", "smoothed", "tail"):
            np.testing.assert_allclose(out[k].numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
        for k in ("ess0", "ess"):
            np.testing.assert_allclose(out[k].numpy(), want[k].numpy(), rtol=1e-5, err_msg=k)


def _kalman(length, seed):
    _, ys = make_lgssm_data(length, seed=seed)
    ll, means, _ = kalman_filter(ys, LGSSMParams())
    return float(ll), np.asarray(means).ravel()


@pytest.mark.parametrize("exchange", ["ppermute", "gather"])
def test_sharded_particle_filter_matches_kalman(group2, exchange):
    ll, means = _kalman(40, 2)
    for out in load(group2, "kalman", 2):
        assert abs(float(out[f"{exchange}_log_ml"]) - ll) < 0.7
        assert np.abs(out[f"{exchange}_means"].numpy().ravel() - means).max() < 0.1


def test_island_particle_filter_matches_kalman(group2):
    ll, means = _kalman(50, 4)
    for out in load(group2, "kalman", 2):
        assert abs(float(out["island_log_ml"]) - ll) < 0.8
        assert np.abs(out["island_means"].numpy().ravel() - means).max() < 0.1


def test_streaming_filter_sharded_matches_kalman(group2):
    xs, ys = make_lgssm_data(300, seed=0)
    ll, means, _ = kalman_filter(ys, LGSSMParams())
    xt = np.asarray(xs).ravel()
    for out in load(group2, "kalman", 2):
        fm, sm = out["stream_means"].numpy().ravel(), out["stream_smoothed"].numpy().ravel()
        assert np.abs(fm - np.asarray(means).ravel()).max() < 0.15
        assert abs(float(out["stream_log_ml"]) - float(ll)) < 2.0
        assert math.sqrt(((sm - xt) ** 2).mean()) < math.sqrt(((fm - xt) ** 2).mean())


@pytest.fixture(scope="module")
def grid():
    _, ys = make_lgssm_data(60, LGSSMParams(a=0.85), seed=0)
    return _kalman_loglik_grid(ys)


@pytest.mark.parametrize("name, world, chains", [
    ("pmmh_chain", 2, 8), ("pmmh_particle", 2, 4), ("pmmh_both", 4, 8),
], ids=["test_pmmh_sharded_chains", "test_pmmh_sharded_particles",
        "test_pmmh_sharded_both_2d_mesh"])
def test_pmmh_sharded_matches_the_kalman_grid(request, grid, name, world, chains):
    mean_a, sd_a = grid
    for out in outputs(request, world, name):
        assert out["thetas"].shape == (chains, 300, 1)
        a = np.tanh(out["thetas"][..., 0].numpy().ravel())
        assert 0.05 < out["accept_rate"] < 0.8
        assert abs(a.mean() - mean_a) < 2.5 * sd_a, (a.mean(), mean_a, sd_a)
        assert 0.3 * sd_a < a.std() < 3.5 * sd_a, (a.std(), sd_a)


@pytest.mark.parametrize("world, name", [
    (w, n) for w in WORLDS for n in ("filter_ring", "filter_gather", "island", "streaming")
] + [(2, "kalman"), (2, "pmmh_chain"), (2, "pmmh_particle"), (4, "pmmh_both")])
def test_every_rank_returns_the_same_result(request, world, name):
    assert_same_on_every_rank(outputs(request, world, name))
