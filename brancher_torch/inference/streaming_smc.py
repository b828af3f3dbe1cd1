"""Streaming SMC: an online bootstrap filter with fixed-lag smoothing.

Counterpart of ``brancher_tpu/inference/streaming_smc.py``
(``StreamingSMC`` and ``streaming_particle_filter``, lines 49-436).  The filter consumes observations chunk by chunk and
carries only the particles, their weights, the running log-marginal and a
ring buffer of each particle's last ``lag`` ancestral states, so its
memory does not grow with the length of the series.  The smoothed
estimate E[x_s | y_{1:s+L}] is the weighted mean of the time-s states of
the current particles' ancestral lines (Kitagawa's fixed-lag
approximation); the buffer is re-indexed by every resampling.

The step is the batch filter's (``smc.bootstrap_step``), branch-free.
There is no compiled program to reuse, so a chunk is not padded to
``chunk_size``: ``process`` takes a chunk of any length, every step a real
one, and ``chunk_size`` only sets how ``streaming_particle_filter`` slices
its input.
The state carries the run's ``SMCRandom``, as JAX's carries its key
(lines 49-63): a state saved with ``checkpoint.save_checkpoint`` (its
generator as its state) and restored with ``restore_checkpoint`` resumes
in a fresh ``StreamingSMC``, even in a new process, bit for bit with the
uninterrupted run.

Sharded mode (``mesh=``, JAX lines 94-140 and 230-344; the SPMD convention
of ``parallel/mesh.py``): the particles split over the mesh's
``particle_axis`` dimension, every rank calls ``init``/``process``/
``finalize`` alike, and the state holds this rank's block of the
particles, weights and ring buffer.  Resampling is the exact global
systematic draw: each step all-gathers the O(P) log-weights, the
resampling uniform comes from the replicated source of the state's
``smc.SplitRandom`` and the particles' draws from its rank-folded
generator.  Each particle's state and its [lag] ancestral line move
together through ONE ``ring_exchange`` of the stacked [lag + 1] states,
on the steps where resampling fires only (one host read a step).  The
filter and smoothed means are one SUM all-reduce a step.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops.resampling import ring_exchange
from ..parallel.collectives import all_gather, psum
from .smc import (
    StateSpace,
    _ess,
    bootstrap_step,
    make_rng,
    particle_axis_of,
    split_rng,
    systematic_resample_indices,
    take_particles,
    weighted_mean,
)

Tensor = torch.Tensor


class StreamingState(NamedTuple):
    """The constant-size carry between chunks (device tensors)."""

    t: int  # next global step index
    x: Tensor  # [P, ...] current particles
    lw: Tensor  # [P] unnormalized log-weights
    log_ml: Tensor  # running log p(y_{0:t-1}) estimate
    lag_buf: Tensor  # [L, P, ...] ring buffer of ancestral states
    rng: object  # the draws of every later chunk (smc.SMCRandom)


class StreamingResult(NamedTuple):
    log_marginal: Tensor
    filter_means: np.ndarray  # [T, ...] E[x_t | y_{0:t}]
    smoothed_means: np.ndarray  # [T, ...] E[x_t | y_{0:min(t+L, T-1)}]
    ess_history: np.ndarray  # [T]


class StreamingSMC:
    """Online bootstrap particle filter with fixed-lag smoothing::

        f = StreamingSMC(ssm, num_particles=1024, lag=16)
        state, (mean0, ess0) = f.init(y0, key)
        for chunk in source:
            state, (means, smoothed, smoothed_times, ess) = f.process(state, chunk)
        tail, times = f.finalize(state)

    Runs on ``device`` (default ``config.device``, or the mesh's device
    type with ``mesh``)."""

    def __init__(self, ssm: StateSpace, num_particles: int = 1024, lag: int = 16,
                 chunk_size: int = 256, ess_threshold: float = 0.5, mesh=None,
                 particle_axis: str = "particle", device=None):
        self.ssm = ssm
        self.num_particles = int(num_particles)
        self.lag = int(lag)
        self.chunk_size = int(chunk_size)
        self.ess_threshold = float(ess_threshold)
        self.axis = None if mesh is None else particle_axis_of(mesh, particle_axis,
                                                               self.num_particles)
        self.device = resolve_device(mesh.device_type if device is None and mesh is not None
                                     else device)

    def _mine(self) -> slice:
        lp = self.num_particles // self.axis.size
        return slice(self.axis.index * lp, (self.axis.index + 1) * lp)

    def init(self, y0, key=None, rng=None):
        """Consume the first observation: (state, (filter_mean_0, ess_0)).
        Sharded, ``rng`` is the shared source or a ``smc.SplitRandom``."""
        p = self.num_particles
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=self.device)
        if self.axis is None:
            rng = make_rng(key, self.device, rng)
            x0 = self.ssm.init_sample(rng.generator, (p,))
            lw0 = torch.broadcast_to(self.ssm.obs_log_prob(y0, x0, 0), (p,))
            lw_all, mean0 = lw0, weighted_mean(torch.softmax(lw0, 0), x0)
        else:
            rng = split_rng(key, self.device, rng, self.axis.index)
            lp = p // self.axis.size
            x0 = self.ssm.init_sample(rng.generator, (lp,))
            lw0 = torch.broadcast_to(self.ssm.obs_log_prob(y0, x0, 0), (lp,))
            lw_all = all_gather(lw0, self.axis)
            mean0 = psum(weighted_mean(torch.exp(lw0 - torch.logsumexp(lw_all, 0)), x0),
                         self.axis)
        log_ml0 = torch.logsumexp(lw_all, 0) - math.log(float(p))
        # slot 0 holds time 0; the others are overwritten before any
        # estimate is emitted from them
        buf = x0[None].repeat((self.lag,) + (1,) * x0.dim())
        state = StreamingState(1, x0, lw0, log_ml0, buf, rng)
        return state, (mean0, _ess(lw_all))

    def _step(self, state: StreamingState, y_t: Tensor):
        t, x, lw, log_ml, buf, rng = state
        x, lw, log_ml, sel = bootstrap_step(self.ssm, x, lw, log_ml, y_t, t, rng,
                                            self.ess_threshold)
        buf = take_particles(buf, sel.expand(buf.shape[:2]))  # re-index the ancestral lines
        w = torch.softmax(lw, 0)
        # slot t % L holds time t - L: emit its smoothed estimate under the
        # current weights, then overwrite it with time t
        slot = t % self.lag
        sm_mean = weighted_mean(w, buf[slot])
        buf[slot] = x  # buf is the gather's fresh copy
        out = (weighted_mean(w, x), sm_mean, t - self.lag, _ess(lw))
        return StreamingState(t + 1, x, lw, log_ml, buf, rng), out

    def _sharded_step(self, state: StreamingState, y_t: Tensor, lw_all: Tensor):
        """``_step`` over this rank's block; ``lw_all`` is the gathered
        log-weights, returned anew for the next step."""
        t, x, lw, log_ml, buf, rng = state
        p, mine = self.num_particles, self._mine()
        do_resample = _ess(lw_all) < self.ess_threshold * p
        idx = systematic_resample_indices(None, lw_all, uniform=rng.uniform(()))[mine]
        if bool(do_resample):  # the same on every rank: the ring runs on all or none
            # each particle's ancestral line moves with it: one ring pass
            # over the stacked [lag + 1] states
            out = ring_exchange(torch.cat([x[:, None], buf.movedim(0, 1)], 1), idx,
                                self.axis.group)
            x, buf = out[:, 0], out[:, 1:].movedim(1, 0).contiguous()
        else:
            buf = buf.clone()  # written below; the old state keeps its own
        lse = torch.logsumexp(lw_all, 0)
        lw_prev = torch.where(do_resample, torch.zeros_like(lw_all),
                              lw_all - lse + math.log(float(p)))
        x = self.ssm.trans_sample(rng.generator, x, t)
        lw = lw_prev[mine] + self.ssm.obs_log_prob(y_t, x, t)
        lw_all = all_gather(lw, self.axis)
        lse_new = torch.logsumexp(lw_all, 0)
        log_ml = log_ml + lse_new - torch.logsumexp(lw_prev, 0)
        w = torch.exp(lw - lse_new)
        slot = t % self.lag
        mean, sm_mean = weighted_mean(w, x), weighted_mean(w, buf[slot])
        both = psum(torch.stack([mean, sm_mean]), self.axis)
        buf[slot] = x
        out = (both[0], both[1], t - self.lag, _ess(lw_all))
        return StreamingState(t + 1, x, lw, log_ml, buf, rng), out, lw_all

    def process(self, state: StreamingState, ys_chunk):
        """Consume a chunk of any length: (state, (filter_means,
        smoothed_means, smoothed_times, ess)), one row per observation;
        smoothed rows with a time below 0 are warm-up placeholders."""
        ys_chunk = torch.as_tensor(ys_chunk, dtype=torch.float32, device=self.device)
        outs = []
        lw_all = None if self.axis is None else all_gather(state.lw, self.axis)
        for y_t in ys_chunk:
            if self.axis is None:
                state, out = self._step(state, y_t)
            else:
                state, out, lw_all = self._sharded_step(state, y_t, lw_all)
            outs.append(out)
        means, sms, times, esss = zip(*outs)
        return state, (torch.stack(means), torch.stack(sms),
                       torch.tensor(times, dtype=torch.int64), torch.stack(esss))

    def finalize(self, state: StreamingState):
        """(smoothed_means [<= lag, ...], times) of the still-buffered tail
        under the final weights, oldest first."""
        if self.axis is None:
            w = torch.softmax(state.lw, 0)
        else:
            w = torch.exp(state.lw - torch.logsumexp(all_gather(state.lw, self.axis), 0))
        times = [state.t - self.lag + j for j in range(self.lag)]
        keep = [s for s in times if s >= 0]
        rows = torch.stack([weighted_mean(w, state.lag_buf[s % self.lag]) for s in keep])
        if self.axis is not None:
            rows = psum(rows, self.axis)
        return rows.cpu().numpy(), np.asarray(keep)


def streaming_particle_filter(ssm: StateSpace, ys, num_particles: int = 1024, key=None,
                              lag: int = 16, chunk_size: int = 256, ess_threshold: float = 0.5,
                              mesh=None, particle_axis: str = "particle",
                              device=None) -> StreamingResult:
    """Filter a whole array through the streaming engine and assemble the
    filter and smoothed means on the host.  With ``mesh=`` the particles
    shard over its ``particle_axis`` dimension (JAX lines 389-412; the
    module docstring), and every rank gets the whole result."""
    ys = np.asarray(ys, np.float32)
    t_len = ys.shape[0]
    f = StreamingSMC(ssm, num_particles, lag, chunk_size, ess_threshold, mesh=mesh,
                     particle_axis=particle_axis, device=device)
    state, (mean0, ess0) = f.init(ys[0], key)
    ev_shape = tuple(mean0.shape)
    filter_means = np.zeros((t_len,) + ev_shape, np.float64)
    smoothed = np.zeros((t_len,) + ev_shape, np.float64)
    ess_hist = np.zeros((t_len,), np.float64)
    filter_means[0] = mean0.cpu().numpy()
    ess_hist[0] = float(ess0)
    pos = 1
    while pos < t_len:
        chunk = ys[pos:pos + chunk_size]
        state, (means, sms, smt, esss) = f.process(state, chunk)
        m = chunk.shape[0]
        filter_means[pos:pos + m] = means.cpu().numpy()
        ess_hist[pos:pos + m] = esss.cpu().numpy()
        smt_np = smt.numpy()
        keep = smt_np >= 0
        smoothed[smt_np[keep]] = sms.cpu().numpy()[keep]
        pos += m
    sm_tail, tail_times = f.finalize(state)
    smoothed[tail_times] = sm_tail
    return StreamingResult(state.log_ml, filter_means, smoothed, ess_hist)


__all__ = ["StreamingState", "StreamingResult", "StreamingSMC", "streaming_particle_filter"]
