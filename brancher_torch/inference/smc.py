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

The sharded filters (``island_particle_filter``, ``sharded_particle_filter``
and ``ops/resampling.py``'s collectives, lines 139-378) wait for the
parallelism item (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..config import make_generator, resolve_device

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


def refuse_sharding(mesh=None, **chosen) -> None:
    """The sharded modes are accepted for API parity and refused: raise
    when ``mesh`` is set or a sharding argument is off its default
    (``chosen`` maps its name to (value, default))."""
    from .mcmc import _not_ported

    moved = [name for name, (value, default) in chosen.items() if value != default]
    if mesh is not None or moved:
        what = "mesh=" if mesh is not None else ", ".join(f"{n}=" for n in moved)
        _not_ported(f"sharded particle methods ({what})", "ROADMAP queue 1, item 15")


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


def smc_sample(ssm: StateSpace, ys, num_particles: int = 1024, key=None, mesh=None,
               particle_axis: str = "particle", ess_threshold: float = 0.5,
               exchange: str = "ppermute", device=None) -> SMCResult:
    """User entry point: particle-filter an explicit StateSpace on one
    device (default ``config.device``).  ``mesh``, ``particle_axis`` and
    ``exchange`` select the JAX package's sharded filters, which are not
    ported: setting them raises (ROADMAP queue 1, item 15)."""
    refuse_sharding(mesh, particle_axis=(particle_axis, "particle"),
                    exchange=(exchange, "ppermute"))
    return particle_filter(ssm, ys, num_particles, key, ess_threshold, device=device)


__all__ = ["StateSpace", "SMCResult", "SMCRandom", "bootstrap_step", "systematic_resample_indices",
           "multinomial_resample_indices", "categorical", "particle_filter", "smc_sample"]
