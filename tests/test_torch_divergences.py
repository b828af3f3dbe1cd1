"""Divergences surface from the port's chain-batched engines: the
counterpart of ``tests/test_divergences.py``.

NUTS, ChEES and HMC each flag a draw whose trajectory crossed the
``max_delta_energy`` threshold at any leapfrog step.  On Neal's funnel
(centered, 10 dimensions) every engine must report a nonzero count, with
``stats["diverging"]`` shaped like ``accept_prob``; on a unit Gaussian
HMC and ChEES must report none (JAX's own checks).

JAX's file also asserts that ChEES's and HMC's counts lie within 20x of
NUTS's at one key.  That holds at JAX's key 0 but not for the engines in
general: over seeds 0-5 (16 chains, 500 + 500) JAX's HMC read 9-388 and
ChEES 18-553 divergent draws, and the port's HMC 11-929 and ChEES 52-493.
The counts are heavy-tailed across seeds: a draw is flagged when any of
its steps diverged, so the count moves with each run's adapted step size
and with how often its chains reach the neck.  So the port is held to the
JAX package's counts over the same six seeds instead: each engine's
median over the seeds within ``MEDIAN_FACTOR`` of JAX's median, JAX run in
the same test (``slow``, as JAX's file is: the port's host-driven NUTS at
max_depth 10 takes about five minutes a seed on a CPU).

The nonzero check runs in the fast gate at a cheaper size fixed before
its first run: 128 chains (on a CPU the cost of a step hardly depends on
the chain count, and more chains give more draws a chance to enter the
neck), 100 + 100, NUTS(max_depth=5) and HMC(num_integration_steps=16), at
seeds 0 and 1, each of which must show nonzero counts on every engine.
Seed 0 costs about 20 s on a CPU and is in the fast gate; seed 1 is
``slow``.
"""
import numpy as np
import pytest
import torch

import brancher_torch.functions as BF
from brancher_torch import NormalVariable, ProbabilisticModel
from brancher_torch.inference import HMC, NUTS, ChEESHMC, sample

# the port's median count over SEEDS within this factor of JAX's, both ways
MEDIAN_FACTOR = 4.0
SEEDS = (0, 1, 2, 3, 4, 5)
FAST_SEEDS = (0, pytest.param(1, marks=pytest.mark.slow))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are many small operations, which
    threads only slow down when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _funnel():
    # Neal's funnel, centered parameterization: the neck has curvature
    # ~exp(-v) and every fixed step size diverges somewhere
    v = NormalVariable(0.0, 3.0, "v")
    x = NormalVariable(torch.zeros(9), BF.exp(v / 2.0), "x")
    return ProbabilisticModel([v, x])


def _counts(kernels, seed, **kw):
    model, out = _funnel(), {}
    for name, kern in kernels:
        r = sample(model, kernel=kern, key=seed, device="cpu", **kw)
        # the per-draw flag has the right shape, and the count is its sum
        assert r.stats["diverging"].shape == r.stats["accept_prob"].shape
        assert int(r.stats["diverging"].sum()) == r.diagnostics["num_divergences"]
        out[name] = r.diagnostics["num_divergences"]
    return out


@pytest.mark.parametrize("seed", FAST_SEEDS)
def test_funnel_divergences_surface_from_all_engines(seed):
    div = _counts([("nuts", NUTS(max_depth=5)), ("chees", ChEESHMC()),
                   ("hmc", HMC(num_integration_steps=16))], seed,
                  num_samples=100, num_warmup=100, num_chains=128)
    assert all(n > 0 for n in div.values()), div


def test_well_conditioned_target_reports_zero():
    # no false positives: a unit Gaussian never trips the 1000-nat gate
    z = NormalVariable(torch.zeros(4), torch.ones(4), "z")
    model = ProbabilisticModel([z])
    for kern in (ChEESHMC(), HMC()):
        r = sample(model, kernel=kern, num_samples=300, num_warmup=300, num_chains=8, key=1,
                   device="cpu")
        assert r.diagnostics["num_divergences"] == 0
        assert r.stats["diverging"].shape == r.stats["accept_prob"].shape


def _jax_counts(engine, seed):
    import jax
    import jax.numpy as jnp

    import brancher_tpu.functions as JBF
    from brancher_tpu import NormalVariable as JNormal, ProbabilisticModel as JModel
    from brancher_tpu.inference import HMC as JHMC, NUTS as JNUTS, ChEESHMC as JChEES
    from brancher_tpu.inference import sample as jsample

    v = JNormal(0.0, 3.0, "v")
    x = JNormal(jnp.zeros(9), JBF.exp(v / 2.0), "x")
    kern = {"nuts": JNUTS, "chees": JChEES, "hmc": JHMC}[engine]()
    r = jsample(JModel([v, x]), kernel=kern, num_samples=500, num_warmup=500, num_chains=16,
                key=jax.random.PRNGKey(seed))
    return int(r.diagnostics["num_divergences"])


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["nuts", "chees", "hmc"])
def test_funnel_counts_match_jax_over_seeds(engine):
    """JAX's configuration (16 chains, 500 + 500, default kernels) at seeds
    0-5 in both packages: nonzero on every seed in the port, and the
    port's median within MEDIAN_FACTOR of JAX's."""
    kern = {"nuts": NUTS, "chees": ChEESHMC, "hmc": HMC}[engine]
    port = [_counts([(engine, kern())], s, num_samples=500, num_warmup=500,
                    num_chains=16)[engine] for s in SEEDS]
    jax_ = [_jax_counts(engine, s) for s in SEEDS]
    assert all(n > 0 for n in port), port
    mp, mj = float(np.median(port)), float(np.median(jax_))
    assert mj / MEDIAN_FACTOR <= mp <= mj * MEDIAN_FACTOR, (engine, port, jax_)
