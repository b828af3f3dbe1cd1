"""Fixed-key reproducibility on the port: every engine gives BIT-IDENTICAL
outputs across two runs with the same key at a fixed device count.  The
counterpart of ``tests/test_determinism.py``, test for test, at its sizes
(``_logreg_model(50, 4)``: 4 chains, 60 + 60).

These tests pin the port's random-stream contract: a refactor that changes
the order in which an engine draws from its ``torch.Generator`` fails here
and must be an intentional, documented change.  As in JAX, what is not
asserted is reproducibility across mesh sizes: a sharded run folds its rank
into its generator, so another world size is another (equally valid)
stream.  The sharded runs are two gloo ranks on the CPU (``tests/
torch_dist.py``, suite "determinism" of ``tests/torch_dist_scenarios.py``);
every rank must return the same global result, and the pairs must be equal.

Also here: ``sample()`` keeps the autodiff value+grad on the compiled model,
so a second call on the same model and data reuses it (on the card: replays
the CUDA graphs the first call captured).
"""
import warnings

import numpy as np
import pytest
import torch

from brancher_torch import NormalVariable, ProbabilisticModel
from brancher_torch.inference import HMC, NUTS, ChEESHMC, sample
from tests.torch_dist import assert_same_on_every_rank, load, run_group
from tests.torch_dist_scenarios import (CONDITIONED_N, conditioned_data,
                                        determinism_logreg_model as _logreg_model)

WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are many small operations, which
    threads only slow down when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run_twice(model, **kw):
    kwargs = dict(num_samples=60, num_warmup=60, num_chains=4, key=0, device="cpu")
    kwargs.update(kw)
    return sample(model, **kwargs), sample(model, **kwargs)


def _assert_bit_identical(r1, r2):
    assert r1.samples.keys() == r2.samples.keys()
    for name in r1.samples:
        assert torch.equal(r1.samples[name], r2.samples[name]), (
            f"samples[{name}] differ between identical-key runs")
    assert torch.equal(r1.stats["accept_prob"], r2.stats["accept_prob"])


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = run_group("determinism", WORLD, tmp_path_factory.mktemp("determinism"))
    return {name: load(out, name, WORLD) for name in ("sharded_reruns", "conditioned_reruns")}


@pytest.mark.parametrize(
    "kernel",
    [NUTS(max_depth=6), NUTS(max_depth=6, pipelined=True),
     HMC(num_integration_steps=8), ChEESHMC()],
    ids=["nuts", "nuts-pipelined", "hmc", "chees"],
)
def test_vectorized_engines_bit_identical(kernel):
    r1, r2 = _run_twice(_logreg_model(), kernel=kernel)
    assert r1.diagnostics["fused_family"] == "bernoulli_logit"  # the fused potential's path
    _assert_bit_identical(r1, r2)


def test_vectorized_nuts_sharded_bit_identical(group):
    """Same key + same mesh (2 ranks) => bit-identical draws, on every rank."""
    outs = group["sharded_reruns"]
    assert_same_on_every_rank(outs)
    out = outs[0]
    assert out["family"] == "bernoulli_logit" and out["w0"].shape[:2] == (8, 60)
    assert torch.equal(out["w0"], out["w1"]) and torch.equal(out["accept0"], out["accept1"])


def test_eager_dispatch_bit_identical():
    """``jit_runner=False`` vs the default run.  JAX documents its eager
    dispatch as the same stream with drifting bits and holds it only to
    itself; the port has no trace step, so ``jit_runner`` does nothing, and
    the run is held to the same bits as the default run: a stronger check
    than JAX's."""
    model = _logreg_model()
    kw = dict(kernel=HMC(num_integration_steps=8))
    r1, r2 = _run_twice(model, jit_runner=False, **kw)
    _assert_bit_identical(r1, r2)
    _assert_bit_identical(r1, _run_twice(model, **kw)[0])


def test_eager_dispatch_sharded_bit_identical(group):
    """``jit_runner=False`` with a mesh: the same bits as the default
    sharded run (JAX holds the two within MC error, 0.2 on the means)."""
    out = group["sharded_reruns"][0]
    assert torch.equal(out["w2"], out["w0"]) and torch.equal(out["accept2"], out["accept0"])


def test_eager_sharded_conditioned_bit_identical(group):
    """Conditioned data (``given``) + sharded chains + ``jit_runner=False``:
    two runs, one key, the same bits on every rank; and the conjugate
    posterior mean of mu, n / (n + 1) times the data's mean, within 0.2
    (JAX's limit)."""
    outs = group["conditioned_reruns"]
    assert_same_on_every_rank(outs)
    out = outs[0]
    assert out["mu1"].shape[:2] == (8, 60)
    assert torch.equal(out["mu1"], out["mu2"]) and torch.equal(out["accept1"], out["accept2"])
    expect = conditioned_data().mean() * CONDITIONED_N / (CONDITIONED_N + 1)
    assert abs(float(out["mu1"].mean()) - expect) < 0.2


def test_bf16_fused_potential_bit_identical():
    """``fused_potential="bf16"`` vs itself (on the CPU the bf16 plain
    version; on the card K2).  A potential that fell back to f32 warns:
    with warnings raised as errors the test fails instead of passing
    vacuously."""
    m = _logreg_model(n=64, d=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r1, r2 = _run_twice(m, kernel=HMC(num_integration_steps=8), fused_potential="bf16")
    assert r1.diagnostics["fused_dtype"] == "bf16"
    _assert_bit_identical(r1, r2)


def test_per_chain_vmap_engine_bit_identical():
    r1, r2 = _run_twice(_logreg_model(), kernel=NUTS(max_depth=6), chain_method="vmap",
                        num_chains=2, num_samples=40, num_warmup=40)
    _assert_bit_identical(r1, r2)


def test_smc_bit_identical():
    from brancher_torch.inference.smc import smc_sample
    from brancher_torch.models.state_space import LGSSMParams, lgssm_state_space, make_lgssm_data

    params = LGSSMParams()
    _, ys = make_lgssm_data(length=50, params=params, seed=1)
    ssm = lgssm_state_space(params)
    r1 = smc_sample(ssm, ys, num_particles=512, key=0, device="cpu")
    r2 = smc_sample(ssm, ys, num_particles=512, key=0, device="cpu")
    assert torch.equal(r1.filter_means, r2.filter_means)
    assert torch.equal(r1.log_marginal, r2.log_marginal)


def test_streaming_smc_bit_identical():
    from brancher_torch.inference.streaming_smc import streaming_particle_filter
    from brancher_torch.models.state_space import LGSSMParams, lgssm_state_space, make_lgssm_data

    params = LGSSMParams()
    _, ys = make_lgssm_data(length=90, params=params, seed=2)
    ssm = lgssm_state_space(params)
    kw = dict(num_particles=256, lag=8, chunk_size=32, key=0, device="cpu")
    r1 = streaming_particle_filter(ssm, ys, **kw)
    r2 = streaming_particle_filter(ssm, ys, **kw)
    np.testing.assert_array_equal(r1.filter_means, r2.filter_means)
    np.testing.assert_array_equal(r1.smoothed_means, r2.smoothed_means)
    assert torch.equal(torch.as_tensor(r1.log_marginal), torch.as_tensor(r2.log_marginal))


def _conjugate_twenty():
    mu = NormalVariable(0.0, 2.0, "mu")
    obs = NormalVariable(mu * torch.ones(20), 1.0, "x")
    obs.observe(np.random.RandomState(0).normal(2, 1, 20).astype(np.float32))
    return obs


def test_tempered_smc_bit_identical():
    from brancher_torch.inference.tempered_smc import smc_posterior_sample

    m = ProbabilisticModel([_conjugate_twenty()])
    s1, r1 = smc_posterior_sample(m, num_particles=256, key=0, device="cpu")
    s2, r2 = smc_posterior_sample(m, num_particles=256, key=0, device="cpu")
    assert torch.equal(torch.as_tensor(r1.log_evidence), torch.as_tensor(r2.log_evidence))
    assert s1.keys() == s2.keys()
    for name in s1:
        assert torch.equal(s1[name], s2[name])


def test_svi_bit_identical():
    from brancher_torch.inference import perform_inference

    obs = _conjugate_twenty()
    losses = []
    for _ in range(2):
        m = ProbabilisticModel([obs])
        out = perform_inference(m, number_iterations=100, number_samples=8, lr=0.05, key=0,
                                device="cpu")
        losses.append(torch.as_tensor(out.loss_curve))
    assert torch.equal(losses[0], losses[1])


def test_sample_twice_reuses_the_autodiff_value_and_grad():
    """The second call on the same model and data takes the first call's
    value+grad from the compiled model's FIFO (keyed by the ``given``'s
    content, as the enumerated potential is) and gives its draws; other
    data gets an entry of its own, and a ``given`` over 16 MB none."""
    def conditioned_model():
        mu = NormalVariable(0.0, 1.0, "mu")
        return ProbabilisticModel([NormalVariable(mu, 1.0, "x", plate_shape=(CONDITIONED_N,))])

    model = conditioned_model()
    data = torch.as_tensor(conditioned_data())
    kw = dict(kernel=NUTS(max_depth=5), num_samples=20, num_warmup=20, num_chains=2, key=0,
              device="cpu")
    r1 = sample(model, given={"x": data}, **kw)
    cache = model.compiled("cpu")._autodiff_vg_cache
    assert len(cache) == 1
    first = next(iter(cache.values()))
    r2 = sample(model, given={"x": data.clone()}, **kw)  # equal content, new tensor
    assert len(cache) == 1 and next(iter(cache.values())) is first
    _assert_bit_identical(r1, r2)
    # no graph on the CPU: nothing captured on either call
    assert r1.diagnostics["value_and_grad_captures"] == 0
    assert r2.diagnostics["value_and_grad_capture_seconds"] == 0.0
    sample(model, given={"x": data + 1.0}, **kw)
    assert len(cache) == 2
    # an entry keeps a copy: the building call's array changed in place
    # does not reach a later call with that call's content
    fresh, mutable = conditioned_model(), data.clone()
    ra = sample(fresh, given={"x": mutable}, **kw)
    mutable += 5.0
    _assert_bit_identical(ra, sample(fresh, given={"x": data.clone()}, **kw))
    big = torch.zeros((1 << 22) + 1)  # over 16 MB of float32
    from brancher_torch.inference.mcmc import _given_key
    assert _given_key({"x": big}) is None
