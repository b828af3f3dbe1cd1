"""Sequential Monte Carlo: the bootstrap particle filter on one device.

Counterpart of ``brancher_tpu/inference/smc.py`` (``StateSpace``,
``SMCResult``, the resampling indices, ``_ess``, ``particle_filter`` and
``smc_sample``; lines 36-137 and 380-421).  The filter is a Python loop
over time; each step works on the whole particle block at once, and
adaptive resampling stays branch-free: the indices are drawn every step
and a ``torch.where`` on the ESS keeps or drops them, so a step never
reads a number back to the host.

The ``StateSpace`` contract differs from the JAX package's, where each
callback works on ONE particle, takes a PRNG key and is ``vmap``ped.
``torch.func.vmap`` refuses random draws, so here every callback works on
a whole block of particles with any leading axes (particles, or chains
and particles), and the samplers take the run's ``torch.Generator``:

  * ``init_sample(generator, shape) -> x0 [*shape, *state]``
  * ``init_log_prob(x0) -> [*shape]``
  * ``trans_sample(generator, x_prev, t) -> x`` (t a python int)
  * ``trans_log_prob(x, x_prev, t) -> [*shape]``
  * ``obs_log_prob(y_t, x, t) -> [*shape]``

The log-probs are elementwise over the leading axes.  ``t`` is a python
int in the filters; particle Gibbs scores a whole trajectory at once and
passes the times [T - 1] as a tensor, with time on the second axis of x
(the JAX package ``vmap``s over a traced t there).  A filter over C
parameter sets at once (PMMH, particle Gibbs) passes ``batch_shape=(C,)``,
and the callbacks see [C, P] blocks.

The filters' own numbers (each step's resampling uniform, the Gumbel
noise of a categorical draw) come from a source with the methods of
``SMCRandom``, by default one over the run's generator; a test passes a
source that replays the JAX package's numbers.

The sharded filters (JAX lines 139-378) split the particles over a mesh
dimension under the SPMD convention of ``parallel/mesh.py``: every rank
calls the filter alike and gets the global result.

  * ``sharded_particle_filter``: exact global systematic resampling.  Each
    step all-gathers the O(P) log-weights, from which every rank computes
    the same ESS, resampling indices, log-marginal increment and ESS
    history (JAX reduces them with pmax/psum; the gathered vector it needs
    for the CDF anyway makes them free here, and bit-identical to the
    single-device filter's).  With ``exchange="ppermute"`` the ancestors'
    state moves over ``ops.resampling.ring_exchange``, only on the steps
    where resampling fires: the predicate is read on the host, one read a
    step (``SMCResult.host_syncs``), as JAX's ``lax.cond``.  ``"gather"``
    all-gathers the state every step.  The filter means are one SUM
    all-reduce a step.
  * ``island_particle_filter``: every rank runs a whole local filter of
    P / n particles with its own resampling, and the islands combine by
    log-mean-exp (an unbiased estimate); the filter means are weighted by
    the islands' weights.

Where the randomness lives: the resampling uniforms come from a
REPLICATED source (JAX's ``shared_key``), so every rank draws the same
global CDF positions; the particles' draws (the StateSpace callbacks'
generator) from one folded with the rank (``SplitRandom``).  An island
draws everything from its rank's source.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..config import make_generator, resolve_device
from ..ops.resampling import ring_exchange
from ..parallel.collectives import Axis, all_gather, fold_in, mesh_axis, pmean, psum

Tensor = torch.Tensor

_TINY = torch.finfo(torch.float32).tiny


class StateSpace(NamedTuple):
    """Explicit state-space model consumed by the particle methods (the
    batched contract of the module docstring)."""

    init_sample: Callable  # (generator, shape) -> x0 [*shape, *state]
    init_log_prob: Callable  # (x0) -> [*shape]
    trans_sample: Callable  # (generator, x_prev, t) -> x
    trans_log_prob: Callable  # (x, x_prev, t) -> [*shape]
    obs_log_prob: Callable  # (y_t, x, t) -> [*shape]


class SMCResult(NamedTuple):
    log_marginal: Tensor  # [*batch] log p(y_{1:T}) estimate
    particles: Tensor  # [*batch, P, *state] final particles
    weights: Tensor  # [*batch, P] final normalized weights
    filter_means: Tensor  # [*batch, T, *state] E[x_t | y_{1:t}]
    ess_history: Tensor  # [*batch, T] effective sample size per step
    host_syncs: int = 0  # device->host reads (the ring filter's predicate)


class SMCRandom:
    """The particle methods' own draws, from one generator: uniforms,
    standard normals and standard Gumbel noise of a given shape."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape) -> Tensor:
        return torch.rand(tuple(shape), generator=self.generator, device=self.generator.device)

    def normal(self, shape) -> Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.generator.device)

    def gumbel(self, shape) -> Tensor:
        # as jax.random.gumbel: uniforms on [tiny, 1)
        return -torch.log(-torch.log(torch.clamp(self.uniform(shape), min=_TINY)))


def make_rng(key, device, rng=None):
    """``rng`` when given, else an ``SMCRandom`` over ``key`` (an int seed
    or a generator on ``device``)."""
    return SMCRandom(make_generator(key, device)) if rng is None else rng


class SplitRandom:
    """A sharded filter's draws: its own numbers (``uniform``, ``normal``,
    ``gumbel``) from ``shared``, replicated on every rank, and
    ``generator``, the one the StateSpace callbacks draw this rank's
    particles with."""

    def __init__(self, shared, generator: Optional[torch.Generator]):
        self.shared = shared
        self.generator = generator

    def uniform(self, shape) -> Tensor:
        return self.shared.uniform(shape)

    def normal(self, shape) -> Tensor:
        return self.shared.normal(shape)

    def gumbel(self, shape) -> Tensor:
        return self.shared.gumbel(shape)


def split_rng(key, device, rng, index) -> SplitRandom:
    """``rng`` when it is a ``SplitRandom``; else the shared source
    ``make_rng(key, device, rng)`` with its generator folded with
    ``index`` for the particles."""
    if isinstance(rng, SplitRandom):
        return rng
    shared = make_rng(key, device, rng)
    return SplitRandom(shared, fold_in(shared.generator, index))


def particle_axis_of(mesh, particle_axis: str, num_particles: int) -> Axis:
    """The mesh's particle dimension; ``num_particles`` must divide over it."""
    axis = mesh_axis(mesh, particle_axis)
    if num_particles % axis.size:
        raise ValueError(f"num_particles={num_particles} must divide over mesh axis "
                         f"{particle_axis!r} of size {axis.size}")
    return axis


def systematic_resample_indices(generator: Optional[torch.Generator], log_weights: Tensor,
                                uniform: Optional[Tensor] = None) -> Tensor:
    """Systematic resampling over the last axis: stratified positions
    (u + i) / P through the weights' CDF, one uniform per leading index
    (``uniform``, else drawn from ``generator``)."""
    p = log_weights.shape[-1]
    w = torch.softmax(log_weights, dim=-1)
    cdf = torch.cumsum(w, dim=-1)
    if uniform is None:
        uniform = torch.rand(log_weights.shape[:-1], generator=generator,
                             device=log_weights.device)
    positions = (uniform[..., None] + torch.arange(p, dtype=w.dtype, device=w.device)) / p
    idx = torch.searchsorted(cdf, positions.contiguous())
    return torch.clamp(idx, 0, p - 1)


def categorical(logits: Tensor, gumbel: Tensor) -> Tensor:
    """Categorical draws over the last axis by the Gumbel-max trick, as
    ``jax.random.categorical``: argmax of the logits plus standard Gumbel
    noise (broadcast against them)."""
    return torch.argmax(gumbel + logits, dim=-1)


def multinomial_resample_indices(generator: Optional[torch.Generator], log_weights: Tensor,
                                 gumbel: Optional[Tensor] = None) -> Tensor:
    """P independent categorical draws from the weights of the last axis,
    on Gumbel noise [*lead, P, P] (``gumbel``, else drawn from
    ``generator``)."""
    p = log_weights.shape[-1]
    if gumbel is None:
        gumbel = SMCRandom(generator).gumbel(log_weights.shape[:-1] + (p, p))
    return categorical(log_weights.unsqueeze(-2), gumbel)


def _ess(log_weights: Tensor) -> Tensor:
    w = torch.softmax(log_weights, dim=-1)
    return 1.0 / torch.sum(w * w, dim=-1)


def take_particles(x: Tensor, idx: Tensor) -> Tensor:
    """x [*lead, P, *state] re-indexed along the particle axis by idx
    [*lead, P]."""
    extra = x.dim() - idx.dim()
    idx = idx.reshape(idx.shape + (1,) * extra).expand(idx.shape + x.shape[idx.dim():])
    return torch.gather(x, idx.dim() - 1, idx)


def weighted_mean(w: Tensor, x: Tensor) -> Tensor:
    """sum_p w_p x_p over the particle axis: w [*lead, P], x [*lead, P, *state]."""
    extra = x.dim() - w.dim()
    return torch.sum(w.reshape(w.shape + (1,) * extra) * x, dim=w.dim() - 1)


def resample_step(x: Tensor, lw: Tensor, do_resample: Tensor, idx: Tensor):
    """The branch-free adaptive step: where ``do_resample`` holds, the
    particles take ``idx`` and the weights reset to zero; elsewhere they
    stay and the weights are normalized to mean one (log-mean kept for the
    marginal likelihood).  Returns (x, lw, the selection made)."""
    p = lw.shape[-1]
    sel = torch.where(do_resample[..., None], idx, torch.arange(p, device=lw.device))
    lse = torch.logsumexp(lw, dim=-1, keepdim=True)
    lw = torch.where(do_resample[..., None], torch.zeros_like(lw), lw - lse + math.log(float(p)))
    return take_particles(x, sel), lw, sel


def bootstrap_step(ssm: StateSpace, x: Tensor, lw: Tensor, log_ml: Tensor, y_t: Tensor, t: int,
                   rng, ess_threshold: float = 0.5, resampling: str = "systematic"):
    """One step of the bootstrap filter over particles x [*batch, P, ...]:
    resample where ESS < ess_threshold * P (branch-free), propagate, weight
    by y_t and add the incremental log-marginal.  Returns (x, lw, log_ml,
    the selection made)."""
    p = lw.shape[-1]
    do_resample = _ess(lw) < ess_threshold * p
    if resampling == "systematic":
        idx = systematic_resample_indices(None, lw, uniform=rng.uniform(lw.shape[:-1]))
    else:
        idx = multinomial_resample_indices(None, lw, gumbel=rng.gumbel(lw.shape + (p,)))
    x, lw, sel = resample_step(x, lw, do_resample, idx)
    x = ssm.trans_sample(rng.generator, x, t)
    lw_new = lw + ssm.obs_log_prob(y_t, x, t)
    # incremental marginal likelihood: log mean of the unnormalized ratio
    log_ml = log_ml + torch.logsumexp(lw_new, dim=-1) - torch.logsumexp(lw, dim=-1)
    return x, lw_new, log_ml, sel


def particle_filter(ssm: StateSpace, ys, num_particles: int, key=None,
                    ess_threshold: float = 0.5, resampling: str = "systematic",
                    batch_shape: Sequence[int] = (), device=None, rng=None) -> SMCResult:
    """Bootstrap particle filter over ``ys`` [T, ...] with adaptive
    resampling (systematic or multinomial) at ESS < ess_threshold * P;
    ``batch_shape`` filters that many independent particle systems at once.
    device: default ``config.device``; key: an int seed or a generator
    there."""
    if resampling not in ("systematic", "multinomial"):
        raise ValueError(f"unknown resampling {resampling!r}")
    dev = resolve_device(device)
    rng = make_rng(key, dev, rng)
    gen = rng.generator
    ys = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    t_len = ys.shape[0]
    batch = tuple(batch_shape)
    p = num_particles
    shape = batch + (p,)

    x = ssm.init_sample(gen, shape)
    lw = torch.broadcast_to(ssm.obs_log_prob(ys[0], x, 0), shape)
    log_ml = torch.logsumexp(lw, dim=-1) - math.log(float(p))
    means = [weighted_mean(torch.softmax(lw, dim=-1), x)]
    esss = [_ess(lw)]
    for t in range(1, t_len):
        x, lw, log_ml, _ = bootstrap_step(ssm, x, lw, log_ml, ys[t], t, rng, ess_threshold,
                                          resampling)
        means.append(weighted_mean(torch.softmax(lw, dim=-1), x))
        esss.append(_ess(lw))
    return SMCResult(log_ml, x, torch.softmax(lw, dim=-1), torch.stack(means, dim=len(batch)),
                     torch.stack(esss, dim=-1))


def _state_sum(w: Tensor, x: Tensor, axis: Axis) -> Tensor:
    """sum over every rank's particles of w_p x_p (w, x this rank's)."""
    return psum(weighted_mean(w, x), axis)


def sharded_particle_filter(ssm: StateSpace, ys, num_particles: int, key=None, mesh=None,
                            particle_axis: str = "particle", ess_threshold: float = 0.5,
                            exchange: str = "ppermute", device=None, rng=None) -> SMCResult:
    """Bootstrap filter with the particles sharded over ``mesh``'s
    ``particle_axis`` and global systematic resampling (module docstring);
    ``exchange`` "ppermute" (the ring, on resampling steps only) or
    "gather" (the whole state every step) give the same result bit for
    bit.  device: default the mesh's device type.  rng: the shared source
    (an ``SMCRandom``-like object; its generator is folded with the rank
    for the particles), or a ``SplitRandom``.  Returns the global result
    on every rank."""
    if exchange not in ("ppermute", "gather"):
        raise ValueError(f"unknown exchange mode {exchange!r}")
    axis = particle_axis_of(mesh, particle_axis, num_particles)
    dev = resolve_device(mesh.device_type if device is None else device)
    rng = split_rng(key, dev, rng, axis.index)
    ys = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    p, lp = num_particles, num_particles // axis.size
    mine = slice(axis.index * lp, (axis.index + 1) * lp)
    log_p = math.log(float(p))

    x = ssm.init_sample(rng.generator, (lp,))
    lw = torch.broadcast_to(ssm.obs_log_prob(ys[0], x, 0), (lp,))
    lw_all = all_gather(lw, axis)
    log_ml = torch.logsumexp(lw_all, 0) - log_p
    means = [_state_sum(torch.exp(lw - torch.logsumexp(lw_all, 0)), x, axis)]
    esss = [_ess(lw_all)]
    syncs = 0
    for t in range(1, ys.shape[0]):
        do_resample = _ess(lw_all) < ess_threshold * p
        idx = systematic_resample_indices(None, lw_all, uniform=rng.uniform(()))[mine]
        if exchange == "ppermute":
            syncs += 1
            if bool(do_resample):  # the same on every rank: the ring runs on all or none
                x = ring_exchange(x, idx, axis.group)
        else:
            x_all = all_gather(x, axis)
            x = x_all[torch.where(do_resample, idx, torch.arange(p, device=dev)[mine])]
        lse = torch.logsumexp(lw_all, 0)
        lw_prev = torch.where(do_resample, torch.zeros_like(lw_all), lw_all - lse + log_p)
        x = ssm.trans_sample(rng.generator, x, t)
        lw = lw_prev[mine] + ssm.obs_log_prob(ys[t], x, t)
        lw_all = all_gather(lw, axis)
        lse_new = torch.logsumexp(lw_all, 0)
        log_ml = log_ml + lse_new - torch.logsumexp(lw_prev, 0)
        means.append(_state_sum(torch.exp(lw - lse_new), x, axis))
        esss.append(_ess(lw_all))
    return SMCResult(log_ml, all_gather(x, axis), torch.softmax(lw_all, 0), torch.stack(means),
                     torch.stack(esss), syncs)


def island_particle_filter(ssm: StateSpace, ys, num_particles: int, key=None, mesh=None,
                           particle_axis: str = "particle", ess_threshold: float = 0.5,
                           device=None, rng=None) -> SMCResult:
    """Island filter (JAX lines 139-241): every rank runs a whole local
    filter of P / n particles with local adaptive systematic resampling,
    whose log-marginal is its island's log-weight; the estimate is their
    log-mean-exp, and the filter means are the islands' means weighted by
    the islands' weights (at t = 0 their plain mean, as JAX).  No particle
    state crosses ranks: two small collectives a step.  rng: this rank's
    source of every draw (default: the key's generator folded with the
    rank)."""
    axis = particle_axis_of(mesh, particle_axis, num_particles)
    dev = resolve_device(mesh.device_type if device is None else device)
    if rng is None:
        rng = SMCRandom(fold_in(make_generator(key, dev), axis.index))
    ys = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    lp = num_particles // axis.size
    log_n = math.log(float(axis.size))

    def log_mean_exp(v):  # over the islands
        return torch.logsumexp(all_gather(v.reshape(1), axis), 0) - log_n

    x = ssm.init_sample(rng.generator, (lp,))
    lw = torch.broadcast_to(ssm.obs_log_prob(ys[0], x, 0), (lp,))
    isl_lw = torch.logsumexp(lw, 0) - math.log(float(lp))
    means = [pmean(weighted_mean(torch.softmax(lw, 0), x), axis)]
    esss = [psum(_ess(lw), axis)]
    for t in range(1, ys.shape[0]):
        x, lw, isl_lw, _ = bootstrap_step(ssm, x, lw, isl_lw, ys[t], t, rng, ess_threshold)
        isl_w = torch.exp(isl_lw - log_mean_exp(isl_lw)) / axis.size
        mean = weighted_mean(torch.softmax(lw, 0), x)
        both = psum(torch.cat([(isl_w * mean).reshape(-1), _ess(lw).reshape(1)]), axis)
        means.append(both[:-1].reshape(mean.shape))
        esss.append(both[-1])
    return SMCResult(log_mean_exp(isl_lw), all_gather(x, axis),
                     torch.softmax(all_gather(lw, axis), 0), torch.stack(means), torch.stack(esss))


def smc_sample(ssm: StateSpace, ys, num_particles: int = 1024, key=None, mesh=None,
               particle_axis: str = "particle", ess_threshold: float = 0.5,
               exchange: str = "ppermute", device=None) -> SMCResult:
    """User entry point: particle-filter an explicit StateSpace, on one
    device (default ``config.device``) or, with ``mesh``, sharded over its
    ``particle_axis`` dimension (JAX lines 380-421):

      * exchange "ppermute" (default): global systematic resampling, the
        ancestors' state over the ring on resampling steps only;
      * "gather" (alias "global"): the same with a state all-gather every
        step;
      * "island": local resampling on every rank, islands combined by
        weight.

    Without a mesh ``exchange`` is ignored, as in JAX."""
    if mesh is None:
        return particle_filter(ssm, ys, num_particles, key, ess_threshold, device=device)
    if exchange == "global":
        exchange = "gather"
    if exchange not in ("ppermute", "gather", "island"):
        raise ValueError(f"unknown exchange mode {exchange!r}")
    if exchange == "island":
        return island_particle_filter(ssm, ys, num_particles, key, mesh, particle_axis,
                                      ess_threshold, device=device)
    return sharded_particle_filter(ssm, ys, num_particles, key, mesh, particle_axis,
                                   ess_threshold, exchange=exchange, device=device)


__all__ = ["StateSpace", "SMCResult", "SMCRandom", "SplitRandom", "bootstrap_step",
           "systematic_resample_indices", "multinomial_resample_indices", "categorical",
           "particle_filter", "sharded_particle_filter", "island_particle_filter", "smc_sample"]
