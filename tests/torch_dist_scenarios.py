"""The sharded runs the gloo groups of ``tests/torch_dist.py`` make: the
MCMC and SVI suite ("mcmc", two ranks), the particle suite ("smc", two
and four ranks) and the reruns at one key ("determinism", two ranks).  Each scenario takes (world, rank) and returns a dict
(None: not run at this world size); keys starting with "local_" hold
what is this rank's own (its value+grad calls), the rest must be the same
on every rank.  Imports torch and brancher_torch only."""
from __future__ import annotations

import math

import numpy as np
import torch

from tests.torch_dist import (
    KeyedNutsRandom, filter_numbers, gaussian_vg, particle_replays, register, replay_lgssm,
)

# the inputs the tests rebuild for the unsharded side
PROBE_CHAINS, PROBE_SCALES = 8, (0.05, 1.0, 3.0)
WINDOW_WARMUP, WINDOW_SEED = 16, 11
FILTER_P, FILTER_T = 64, 25
STREAM_LAG, STREAM_CHUNKS = 4, (7, 10, 7)


def probe_inputs():
    """z [8, 3] and the momenta's normals for the step-size probe."""
    rs = np.random.RandomState(1)
    return (rs.uniform(-2, 2, size=(PROBE_CHAINS, 3)).astype(np.float32),
            rs.normal(size=(PROBE_CHAINS, 3)).astype(np.float32))


def filter_ys():
    from brancher_torch.models import make_lgssm_data

    return make_lgssm_data(FILTER_T, seed=1)[1]


def _rows(n, world, rank):
    lp = n // world
    return slice(rank * lp, (rank + 1) * lp)


def _chain_axis():
    from brancher_torch.parallel import chain_mesh, mesh_axis

    return mesh_axis(chain_mesh(device="cpu"), "chain")


def _samples(res, name):
    return {f"{name}": res.samples[name], "step_size": torch.as_tensor(res.diagnostics["step_size"]),
            "local_vg_calls": res.diagnostics["value_and_grad_calls"]}


# ---------------------------------------------------------------------------
# MCMC and SVI (two ranks)
@register("mcmc")
def _probe_scenario(world, rank):
    from brancher_torch.inference.adaptation import find_reasonable_step_size_batched

    axis = _chain_axis()
    z, noise = probe_inputs()
    rows = _rows(PROBE_CHAINS, world, rank)
    step = find_reasonable_step_size_batched(
        gaussian_vg(PROBE_SCALES), torch.as_tensor(z[rows]), torch.ones(3), init_step=1.0,
        noise=torch.as_tensor(noise[rows]), axis=axis)
    return {"step": step}


@register("mcmc")
def _warmup_window_scenario(world, rank):
    from brancher_torch.inference.vectorized_nuts import nuts_batched
    from brancher_torch.parallel import all_gather

    axis = _chain_axis()
    z, _ = probe_inputs()
    rows = _rows(PROBE_CHAINS, world, rank)
    res = nuts_batched(gaussian_vg(PROBE_SCALES), torch.as_tensor(z[rows]), WINDOW_WARMUP, 3,
                       rng=KeyedNutsRandom(WINDOW_SEED, PROBE_CHAINS, rows), max_depth=5,
                       init_step_size=0.5, axis=axis)
    return {"step_size": res.step_size, "inv_mass": res.inv_mass,
            "samples": all_gather(res.samples, axis)}


@register("mcmc")
def _nuts_conjugate_scenario(world, rank):
    """tests/test_vectorized_nuts.py::test_vectorized_sharded's run."""
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.models import conjugate_normal_model
    from brancher_torch.parallel import chain_mesh

    model, _ = conjugate_normal_model(num_obs=20)
    res = sample(model, kernel=NUTS(max_depth=6), num_samples=400, num_warmup=400, num_chains=16,
                 key=0, mesh=chain_mesh(device="cpu"))
    out = _samples(res, "mu")
    out["warmup_leapfrog"] = float(res.diagnostics["warmup_leapfrog"])
    out["num_steps"] = res.stats["num_steps"]
    return out


@register("mcmc")
def _hmc_shard_map_scenario(world, rank):
    """tests/test_inference_conjugate.py::test_mcmc_sharded_chains's run."""
    from brancher_torch.inference import HMC, sample
    from brancher_torch.models import conjugate_normal_model
    from brancher_torch.parallel import chain_mesh

    model, _ = conjugate_normal_model()
    res = sample(model, kernel=HMC(num_integration_steps=16), num_samples=400, num_warmup=400,
                 num_chains=8, key=0, chain_method="shard_map", mesh=chain_mesh(device="cpu"))
    return _samples(res, "mu")


@register("mcmc")
def _determinism_scenario(world, rank):
    """tests/test_determinism.py::test_vectorized_nuts_sharded_bit_identical's
    runs, on the fused logistic potential (its plain version on the CPU)."""
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.models import logistic_regression_model, make_logreg_data
    from brancher_torch.parallel import chain_mesh

    x, y, _ = make_logreg_data(50, 4, seed=0)
    model = logistic_regression_model(x, y)
    kw = dict(kernel=NUTS(max_depth=6), num_samples=60, num_warmup=60, num_chains=8, key=3,
              mesh=chain_mesh(device="cpu"))
    r1, r2 = sample(model, **kw), sample(model, **kw)
    return {"w1": r1.samples["w"], "w2": r2.samples["w"], "family": r1.diagnostics["fused_family"]}


@register("mcmc")
def _modes_scenario(world, rank):
    """Dense mass, the pipelined engine and ChEES with a mesh."""
    from brancher_torch.inference import NUTS, ChEESHMC, sample
    from brancher_torch.models import conjugate_normal_model
    from brancher_torch.parallel import chain_mesh

    model, _ = conjugate_normal_model()
    mesh = chain_mesh(device="cpu")
    kw = dict(num_samples=300, num_warmup=300, num_chains=8, key=5, mesh=mesh)
    dense = sample(model, kernel=NUTS(max_depth=6), mass="dense", **kw)
    piped = sample(model, kernel=NUTS(max_depth=6, pipelined=True), **kw)
    chees = sample(model, kernel=ChEESHMC(), **kw)
    return {"dense": dense.samples["mu"], "dense_stage_a_draws": dense.diagnostics["dense_stage_a"][
        "num_samples"], "dense_inv_mass": dense.diagnostics["inv_mass"],
            "pipelined": piped.samples["mu"], "chees": chees.samples["mu"],
            "chees_trajectory": torch.as_tensor(chees.diagnostics["trajectory_length"])}


def svi_setup():
    """tests/test_logreg_vae.py::test_sharded_elbo_matches_local's model, its
    compiled form, a mean-field guide and its start, and 16 noise rows."""
    from brancher_torch.inference.guides import AutoMeanField
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    x, y, _ = make_logreg_data(200, 4, seed=2)
    model = logistic_regression_model(x, y)
    comp = model.compiled("cpu")
    guide = AutoMeanField(comp)
    q = guide.init_params(torch.Generator().manual_seed(0))
    noise = np.random.RandomState(4).normal(size=(16, comp.dim)).astype(np.float32)
    return model, comp, guide, {"p": dict(comp.initial_params), "q": q}, noise


@register("mcmc")
def _svi_grads_scenario(world, rank):
    from brancher_torch.inference.svi import ReverseKL, average_over_ranks
    from brancher_torch.optimizers import set_grads, trainable_copy
    from brancher_torch.parallel import batch_mesh, mesh_axis

    axis = mesh_axis(batch_mesh(device="cpu"), "batch")
    _, comp, guide, params0, noise = svi_setup()
    loss_fn = ReverseKL().make_loss(comp, guide)
    params, leaves = trainable_copy(params0)
    rows = _rows(16, world, rank)
    loss = loss_fn(params, None, 16 // world, draws={"noise": torch.as_tensor(noise[rows])})
    set_grads(loss, leaves)
    loss = average_over_ranks(loss, leaves, axis)
    return {"loss": loss, "loc_grad": params["q"]["loc"].grad,
            "log_scale_grad": params["q"]["log_scale"].grad}


@register("mcmc")
def _svi_run_scenario(world, rank):
    from brancher_torch.inference import perform_inference
    from brancher_torch.parallel import batch_mesh

    model = svi_setup()[0]
    res = perform_inference(model, number_iterations=500, number_samples=16, lr=0.05, key=0,
                            mesh=batch_mesh(device="cpu"))
    return {"loc": res.params["q"]["loc"], "log_scale": res.params["q"]["log_scale"],
            "loss_curve": torch.as_tensor(res.loss_curve)}


# ---------------------------------------------------------------------------
# particle methods (two and four ranks)
def _filter(world, rank, exchange):
    from brancher_torch.inference.smc import SplitRandom, sharded_particle_filter
    from brancher_torch.parallel import particle_mesh

    normals, uniforms = filter_numbers(FILTER_P, FILTER_T, seed=3)
    own, shared = particle_replays(normals, uniforms, _rows(FILTER_P, world, rank))
    res = sharded_particle_filter(replay_lgssm(own), filter_ys(), FILTER_P,
                                  mesh=particle_mesh(device="cpu"), exchange=exchange,
                                  rng=SplitRandom(shared, None))
    assert own.done() and shared.done()
    return {"log_ml": res.log_marginal, "means": res.filter_means, "ess": res.ess_history,
            "particles": res.particles, "weights": res.weights, "syncs": res.host_syncs}


@register("smc")
def _filter_ring_scenario(world, rank):
    return _filter(world, rank, "ppermute")


@register("smc")
def _filter_gather_scenario(world, rank):
    return _filter(world, rank, "gather")


def island_numbers(world, rank):
    """Island ``rank``'s own numbers: (normals [T, P / n], uniforms)."""
    return filter_numbers(FILTER_P // world, FILTER_T, seed=100 + 10 * world + rank)


@register("smc")
def _island_scenario(world, rank):
    from brancher_torch.inference.smc import island_particle_filter
    from brancher_torch.parallel import particle_mesh

    normals, uniforms = island_numbers(world, rank)
    own, shared = particle_replays(normals, uniforms)
    res = island_particle_filter(replay_lgssm(own), filter_ys(), FILTER_P,
                                 mesh=particle_mesh(device="cpu"), rng=shared)
    return {"log_ml": res.log_marginal, "means": res.filter_means, "ess": res.ess_history}


def stream(ssm, rng, mesh=None):
    """The streaming filter over ``filter_ys()`` in STREAM_CHUNKS: every
    output concatenated."""
    from brancher_torch.inference.streaming_smc import StreamingSMC

    ys = filter_ys()
    f = StreamingSMC(ssm, FILTER_P, lag=STREAM_LAG, mesh=mesh, device="cpu")
    state, (mean0, ess0) = f.init(ys[0], rng=rng)
    outs, pos = [], 1
    for n in STREAM_CHUNKS:
        state, out = f.process(state, ys[pos:pos + n])
        outs.append(out)
        pos += n
    tail, times = f.finalize(state)
    return {"mean0": mean0, "ess0": ess0, "log_ml": state.log_ml,
            "means": torch.cat([o[0] for o in outs]), "smoothed": torch.cat([o[1] for o in outs]),
            "times": torch.cat([o[2] for o in outs]), "ess": torch.cat([o[3] for o in outs]),
            "tail": torch.as_tensor(tail), "tail_times": torch.as_tensor(times)}


@register("smc")
def _streaming_scenario(world, rank):
    from brancher_torch.inference.smc import SplitRandom
    from brancher_torch.parallel import particle_mesh

    normals, uniforms = filter_numbers(FILTER_P, FILTER_T, seed=7)
    own, shared = particle_replays(normals, uniforms, _rows(FILTER_P, world, rank))
    return stream(replay_lgssm(own), SplitRandom(shared, None), particle_mesh(device="cpu"))


@register("smc")
def _kalman_scenario(world, rank):
    """tests/test_smc.py's sharded, island and sharded streaming runs
    (:41-53, :75-88, :171-196), two ranks."""
    if world != 2:
        return None
    from brancher_torch.inference import smc_sample, streaming_particle_filter
    from brancher_torch.models import LGSSMParams, lgssm_state_space, make_lgssm_data
    from brancher_torch.parallel import particle_mesh

    ssm, mesh = lgssm_state_space(LGSSMParams()), particle_mesh(device="cpu")
    out = {}
    _, ys = make_lgssm_data(40, seed=2)
    for ex in ("ppermute", "gather"):
        res = smc_sample(ssm, ys, num_particles=2048, key=0, mesh=mesh, exchange=ex)
        out[f"{ex}_log_ml"], out[f"{ex}_means"] = res.log_marginal, res.filter_means
    _, ys = make_lgssm_data(50, seed=4)
    res = smc_sample(ssm, ys, num_particles=4096, key=0, mesh=mesh, exchange="island")
    out["island_log_ml"], out["island_means"] = res.log_marginal, res.filter_means
    _, ys = make_lgssm_data(300, seed=0)
    res = streaming_particle_filter(ssm, ys, num_particles=2048, key=0, lag=16, chunk_size=64,
                                    mesh=mesh)
    out["stream_log_ml"] = torch.as_tensor(res.log_marginal)
    out["stream_means"] = torch.as_tensor(res.filter_means)
    out["stream_smoothed"] = torch.as_tensor(res.smoothed_means)
    return out


def pmmh_ssm(theta):
    """tests/test_pmmh.py's LGSSM with a = tanh(theta[0]), over [C, P]."""
    from brancher_torch.inference.smc import StateSpace
    from brancher_torch.models import LGSSMParams

    a = torch.tanh(theta[:, 0])[:, None]
    p = LGSSMParams()

    def randn(g, shape):
        return torch.randn(tuple(shape), generator=g, device=g.device)

    return StateSpace(
        init_sample=lambda g, shape: math.sqrt(p.init_var) * randn(g, shape),
        init_log_prob=lambda x: -0.5 * x * x / p.init_var,
        trans_sample=lambda g, xp, t: a * xp + math.sqrt(p.q) * randn(g, xp.shape),
        trans_log_prob=lambda x, xp, t: -0.5 * (x - a * xp) ** 2 / p.q,
        obs_log_prob=lambda y, x, t: -0.5 * (y - p.c * x) ** 2 / p.r - 0.5 * math.log(2 * math.pi * p.r),
    )


def _pmmh(mesh, shard, num_particles, num_chains):
    from brancher_torch.inference import pmmh_sample
    from brancher_torch.models import LGSSMParams, make_lgssm_data

    _, ys = make_lgssm_data(60, LGSSMParams(a=0.85), seed=0)
    res = pmmh_sample(pmmh_ssm, ys, lambda th: -0.5 * torch.sum((th / 1.5) ** 2, dim=-1),
                      [float(np.arctanh(0.7))], num_samples=300, num_warmup=150,
                      num_particles=num_particles, num_chains=num_chains, key=0, mesh=mesh,
                      shard=shard)
    return {"thetas": res.thetas, "accept_rate": float(res.accept_rate),
            "scale": res.proposal_scale}


@register("smc")
def _pmmh_chain_scenario(world, rank):
    """tests/test_pmmh.py::test_pmmh_sharded_chains's run."""
    from brancher_torch.parallel import chain_mesh

    return _pmmh(chain_mesh(device="cpu"), "chain", 128, 8) if world == 2 else None


@register("smc")
def _pmmh_particle_scenario(world, rank):
    """tests/test_pmmh.py::test_pmmh_sharded_particles's run."""
    from brancher_torch.parallel import particle_mesh

    return _pmmh(particle_mesh(device="cpu"), "particle", 256, 4) if world == 2 else None


@register("smc")
def _pmmh_both_scenario(world, rank):
    """tests/test_pmmh.py::test_pmmh_sharded_both_2d_mesh's run on a 2 x 2
    mesh."""
    from brancher_torch.parallel import make_mesh

    if world != 4:
        return None
    return _pmmh(make_mesh({"chain": 2, "particle": 2}, device="cpu"), "both", 128, 8)


# ---------------------------------------------------------------------------
# reruns at one key (two ranks): tests/test_torch_determinism.py
def determinism_logreg_model(n=50, d=4, seed=0):
    """tests/test_determinism.py::_logreg_model in the port's DSL."""
    import brancher_torch.functions as BF
    from brancher_torch import BernoulliVariable, NormalVariable, ProbabilisticModel

    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, size=(n, d)).astype(np.float32)
    w_true = rng.normal(0, 1, size=(d,)).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ w_true))).astype(np.float32)
    w = NormalVariable(np.zeros(d, np.float32), np.ones(d, np.float32), "w")
    obs = BernoulliVariable(logits=BF.matmul(torch.as_tensor(x), w), name="y")
    obs.observe(y)
    return ProbabilisticModel([obs])


CONDITIONED_N = 64


def conditioned_data():
    """tests/test_determinism.py::test_eager_sharded_conditioned_bit_identical's x."""
    return np.random.RandomState(3).randn(CONDITIONED_N).astype(np.float32)


@register("determinism")
def _sharded_reruns_scenario(world, rank):
    """Sharded NUTS three times at one key: twice by default, once with
    ``jit_runner=False``."""
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.parallel import chain_mesh

    model = determinism_logreg_model()
    kw = dict(kernel=NUTS(max_depth=6), num_samples=60, num_warmup=60, num_chains=8, key=0,
              mesh=chain_mesh(device="cpu"))
    runs = [sample(model, **kw), sample(model, **kw), sample(model, jit_runner=False, **kw)]
    out = {"family": runs[0].diagnostics["fused_family"]}
    for i, r in enumerate(runs):
        out[f"w{i}"], out[f"accept{i}"] = r.samples["w"], r.stats["accept_prob"]
    return out


@register("determinism")
def _conditioned_reruns_scenario(world, rank):
    """The conditioned (``given=``) sharded run with ``jit_runner=False``,
    twice at one key."""
    from brancher_torch import NormalVariable, ProbabilisticModel
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.parallel import chain_mesh

    mu = NormalVariable(0.0, 1.0, "mu")
    x = NormalVariable(mu, 1.0, "x", plate_shape=(CONDITIONED_N,))
    model = ProbabilisticModel([x])
    kw = dict(kernel=NUTS(max_depth=6), num_samples=60, num_warmup=60, num_chains=8, key=0,
              mesh=chain_mesh(device="cpu"), jit_runner=False,
              given={"x": torch.as_tensor(conditioned_data())}, given_key="d1")
    r1, r2 = sample(model, **kw), sample(model, **kw)
    return {"mu1": r1.samples["mu"], "mu2": r2.samples["mu"],
            "accept1": r1.stats["accept_prob"], "accept2": r2.stats["accept_prob"]}
