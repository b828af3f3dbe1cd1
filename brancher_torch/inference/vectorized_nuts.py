"""Vectorized (chain-batched) NUTS: all chains advance in lockstep, or
draw-pipelined in the sampling phase.

Counterpart of ``brancher_tpu/inference/vectorized_nuts.py``:
``nuts_transition_batched`` (lines 100-311), ``_pipelined_sampling``
(lines 314-728) and ``nuts_batched`` (lines 729-839).

One tree, two schedules.  The tree's doubling schedule is deterministic:
leaf n belongs to doubling floor(log2 n) at in-subtree position
m = n - 2^depth.  ``_NutsTree`` holds the tree's state in buffers that its
``start`` and ``leaf`` update in place, and reads leaf n's schedule (the
subtree's start and end flags, the U-turn slot range, the checkpoint
slot) from a precomputed row a leaf index, so the schedule's branches are
selects and every leaf issues the same ops.  In the JAX package that
schedule is computed on the device inside a ``while_loop``; here the loop
runs on the host, and n is a tensor on the device:

- lockstep (``nuts_transition_batched``): n is one leaf index shared by
  every chain; a transition is the start and the leaves until every chain
  has stopped.  On CUDA the start and the leaf are captured once into a
  CUDA graph each and replayed, so the host issues one graph launch a
  leaf; the loop condition ``any(active)`` costs one host sync per leaf.
- pipelined (``NUTS(pipelined=True)``, the sampling phase): n is a leaf
  index per chain, so each chain reads its own row.  A chain refreshes its
  momentum and starts its next draw (a start masked to it) in the
  iteration after its U-turn; a chain ``lookahead`` draws ahead of the
  slowest idles (JAX's ring backpressure, kept as a counter: the ring
  itself only dodged XLA's scatter copies inside a while loop, so each
  completed draw is written straight into the output by index).  One leaf
  and one host sync an iteration.

Randomness is injectable: a transition reads its momenta and, per leaf,
its direction, swap and take draws from a source object with the
methods of ``TorchNutsRandom``, so a test can replay JAX's stream
(``k_mom`` normals; per leaf ``fold_in(k_loop, n)`` split in three; per
pipelined iteration ``fold_in(key, it)`` split in four) and hold one
transition to the JAX one.

Sharded chains (``axis``, JAX's ``axis_name``; ``_gmean``/``_gsum`` at
lines 38-45): the warmup's mean accept probability is the mean over ranks
of each rank's chain mean, and a window's mass comes from the moments
summed over ranks (one all-reduce at the window's end: the sums are
linear, so this is JAX's psum of each rank's running sums).  The tree's
loop and the pipelined loop run no collective, since each rank's loop
ends on its own chains' U-turns.

With ``metrics.tracing()`` on, the lockstep engine records its spans and
counters (``nuts.warmup``, ``nuts.window``, ``nuts.draws``, ``nuts.leaf``,
``nuts.sync``, ``nuts.leaf_capture``; ``nuts.leaves``, ``nuts.live_leaves``,
``nuts.depth_hist``, ``nuts.graph_leaves``, ``nuts.eager_leaves``,
``nuts.kernel_leaves``, ``nuts.tree_state_bytes``: ``metrics.tracing``'s
docstring), and the pipelined sampling phase its ``nuts.draws``, a
``nuts.leaf`` with its ``nuts.sync`` each iteration, ``nuts.leaves``,
``nuts.kernel_leaves`` and ``nuts.live_leaves``.  A
transition or a pipelined loop reads the recorder once; off, each point in
its loop is one ``is None`` test.  The counters are summed on the device
and change no number the engine computes.
"""
from __future__ import annotations

import functools
import math
import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import metrics as _metrics
from .adaptation import (
    build_warmup_schedule, da_init, da_restart, da_update, diag_mass_update, pmean_if, psum_if,
)
from .hmc import TorchRandom

Tensor = torch.Tensor
VG = Callable[[Tensor], Tuple[Tensor, Tensor]]


class TorchNutsRandom(TorchRandom):
    """The randomness of NUTS transitions, drawn from a torch.Generator.

    ``momentum(z)`` returns standard normals shaped like z; ``leaf(n, c)``
    returns, for leaf n of the current tree, (direction is +1 [C] bool,
    swap uniforms [C], take uniforms [C]).  The JAX package draws the
    direction as ``bernoulli(0.5)``, i.e. a uniform below one half.
    """

    def leaf(self, n: int, c: int, like: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        u = torch.rand((3, c), generator=self.generator, device=like.device, dtype=like.dtype)
        return u[0] < 0.5, u[1], u[2]

    def iteration(self, it: int, z: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """Pipelined iteration ``it``: (momentum normals like z, direction
        is +1 [C] bool, swap uniforms [C], take uniforms [C])."""
        c = z.shape[0]
        u = torch.rand((3, c), generator=self.generator, device=z.device, dtype=z.dtype)
        return self.momentum(z), u[0] < 0.5, u[1], u[2]


class Transition(NamedTuple):
    z: Tensor
    val: Tensor
    grad: Tensor
    accept_prob: Tensor  # [C]
    diverging: Tensor  # [C]
    num_leaves: int  # leaf iterations run (shared by the chains)
    mean_live: Tensor  # mean per-chain live leapfrogs
    host_syncs: int
    graph_leaves: int  # of num_leaves, those replayed from a CUDA graph


class VectorizedNUTSResult(NamedTuple):
    samples: Tensor  # [C, S, d]
    accept_prob: Tensor  # [C, S]
    diverging: Tensor  # [C, S]
    num_leapfrog: Tensor  # [S] loop iterations per draw (pipelined: amortised)
    step_size: Tensor
    inv_mass: Tensor
    warmup_leapfrog: int  # loop iterations during warmup
    chain_leapfrog: Tensor  # [S] mean per-chain live leapfrogs per draw
    host_syncs: int  # device->host syncs of the whole run
    sampling_seconds: float  # host clock of the draws' loop (it ends at a host sync)
    # lockstep leaves replayed from a CUDA graph: value+grad calls that the
    # function itself did not see
    graph_leaves: int


def _ke(r: Tensor, inv_mass: Tensor) -> Tensor:
    return 0.5 * torch.sum(r * r * inv_mass[None, :], dim=-1)


def _turning(rho: Tensor, r_a: Tensor, r_b: Tensor, inv_mass: Tensor) -> Tensor:
    va = r_a * inv_mass[None, :]
    vb = r_b * inv_mass[None, :]
    return (torch.sum(rho * va, -1) <= 0.0) | (torch.sum(rho * vb, -1) <= 0.0)


def _sel(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """where(mask, a, b) with a [C] mask over [C] or [C, d] values."""
    return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)


def _col(mask: Tensor) -> Tensor:
    """A [C] mask over [C, d] values or stacked [k, C, d] points (a [1]
    mask over all of them)."""
    return mask[:, None]


def _schedule_tables(max_n: int, device) -> Tuple[Tensor, Tensor]:
    """popcount and floor(log2) of every leaf index a tree of ``max_n``
    leaves reaches (log2 of 0 read as 0)."""
    popcount = torch.tensor([bin(i).count("1") for i in range(max_n + 1)], device=device)
    log2 = torch.tensor([max(i, 1).bit_length() - 1 for i in range(max_n + 1)], device=device)
    return popcount, log2


def _schedule(n: Tensor, popcount: Tensor, log2: Tensor):
    """The doubling schedule at leaf indices n >= 1 (an int64 tensor), read
    from ``_schedule_tables``: (depth, m, pc, lo, even, is_end), with depth
    = floor(log2 n), m = n - 2^depth the leaf's position in that doubling's
    subtree, pc = popcount(m) the checkpoint slot of an even leaf, [lo, pc)
    the slots an odd leaf's U-turn checks read, and is_end true at the
    subtree's last leaf."""
    depth = log2[n]
    m = n - (1 << depth)
    pc = popcount[m]
    lo = pc - popcount[(m ^ (m + 1)) >> 1]
    return depth, m, pc, lo, m % 2 == 0, m == (1 << depth) - 1


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device):
    """The side stream of a device on which every lockstep tree runs its
    first transition and captures its graphs: K1-K4 keep their scratch per
    stream, so one stream a device lets every capture share one scratch."""
    return torch.cuda.Stream(device=device)


class _NutsTree:
    """The NUTS tree at one shape: C chains of d coordinates in one dtype
    on one device, to ``max_depth`` doublings; both engines run it.

    Its state lives in buffers that ``start`` and ``leaf`` update in place,
    and leaf n's schedule is read on the device from the rows of ``flags``
    and ``slot`` at n, so every leaf issues the same ops.  n is [1] for the
    lockstep engine (one leaf index that each leaf advances) and [C] for
    the pipelined one (a leaf index per chain, 0 for a chain between
    draws, whose row is leaf 1's); either way the rows broadcast over the
    chains.  On CUDA with a ``TorchNutsRandom`` the lockstep tree's first
    transition runs eagerly on ``_capture_stream`` (the warm-up), then the
    start and the leaf are captured into one CUDA graph each over the
    tree's own generator, whose state is the caller's for the time of a
    transition; every later transition replays them (``graphs``).
    Elsewhere (the CPU, a replayed random stream, a capture that failed:
    ``graphs`` False) the same two functions run eagerly.  On CUDA a
    leaf's bookkeeping is kernel K7 (``ops/nuts_leaf.py``), eager or
    replayed; on the CPU it is ``plain_leaf``."""

    def __init__(self, c: int, d: int, dtype, device, max_depth: int, max_delta_energy: float):
        kdim = max_depth + 1
        self.max_n = 2**max_depth
        self.max_delta_energy = max_delta_energy

        def zeros(*shape, kind=dtype):
            return torch.zeros(shape, dtype=kind, device=device)

        # inputs, copied in at each lockstep transition (warmup changes eps
        # and the mass); the pipelined engine moves a chain's position here
        self.z, self.val, self.grad = zeros(c, d), zeros(c), zeros(c, d)
        self.eps, self.inv_mass = zeros(), zeros(d)
        self.n = zeros(1, kind=torch.int64)
        # leaf n's schedule (``_schedule``), a row a leaf index: ``flags``
        # the subtree's start and end, then the slots an odd leaf's U-turn
        # checks read ([lo, pc); none for an even leaf); ``slot`` the
        # checkpoint row it writes (pc of an even leaf, the spare row kdim
        # of an odd one)
        n = torch.arange(self.max_n + 1, device=device).clamp(min=1)
        _, m, pc, lo, even, is_end = _schedule(n, *_schedule_tables(self.max_n, device))
        slots = torch.arange(kdim, device=device)
        self.flags = torch.cat([torch.stack([m == 0, is_end], 1),
                                (slots >= lo[:, None]) & (slots < pc[:, None]) & ~even[:, None]], 1)
        self.slot = torch.where(even, pc, kdim)
        # points are stacked: ends [2, 3, C, d] the (left, right) ends' (z,
        # grad, r), mov the subtree's moving end, prop and sp the (z, grad)
        # of the tree's and the subtree's proposals
        self.ends, self.mov = zeros(2, 3, c, d), zeros(3, c, d)
        self.prop, self.sp = zeros(2, c, d), zeros(2, c, d)
        self.prop_val, self.sp_val, self.h0, self.lw = zeros(c), zeros(c), zeros(c), zeros(c)
        self.s_lw, self.dirn, self.sum_acc, self.cnt = zeros(c), zeros(c), zeros(c), zeros(c)
        self.r_sum, self.s_cum = zeros(c, d), zeros(c, d)
        self.s_failed, self.active, self.diverging = (zeros(c, kind=torch.bool) for _ in range(3))
        # checkpoint stacks, depth-major; row kdim takes the odd leaves' writes
        self.r_ck, self.rs_ck = zeros(kdim + 1, c, d), zeros(kdim + 1, c, d)
        # on CUDA the leaf's bookkeeping is kernel K7 (``ops/nuts_leaf.py``):
        # the drift it hands the potential, each chain's schedule row from
        # its head to its tail, and its launch arguments over these buffers
        self.z_new = self.row = self.leaf_args = None
        if torch.device(device).type == "cuda":
            from ..ops.nuts_leaf import BUFFERS, NUTS_LEAF

            self.z_new, self.row = zeros(c, d), zeros(c, kind=torch.int64)
            self.leaf_args = NUTS_LEAF.bind({f: getattr(self, f) for f in BUFFERS},
                                            max_delta_energy)
        # the bytes of the device state above (37 [C, d] tensors and a few
        # [C] ones; on CUDA K7's two more), counted once a transition as
        # ``nuts.tree_state_bytes``
        self.state_bytes = sum(t.numel() * t.element_size() for t in vars(self).values()
                               if isinstance(t, Tensor))
        self.graphs = self.gen = None
        self.launched = []

    def start(self, mom: Tensor, mask: Optional[Tensor] = None) -> None:
        """The tree's start at the inputs from the momentum normals ``mom``:
        energy, both ends at (z, grad, r0), the proposal at z, the
        accumulators cleared, n = 1; for every chain, or for those of the
        [C] ``mask`` alone.  (A subtree's proposal needs none: its first
        live leaf always takes it.)"""
        r0 = mom / torch.sqrt(self.inv_mass)[None, :]
        h0 = -self.val + _ke(r0, self.inv_mass)
        point = torch.stack([self.z, self.grad, r0])
        for buf, x in ((self.h0, h0), (self.ends, point), (self.prop, point[:2]),
                       (self.prop_val, self.val), (self.r_sum, r0)):
            if mask is None:
                buf.copy_(x)
            else:
                torch.where(_col(mask) if buf.dim() > 1 else mask, x, buf, out=buf)
        for buf, x in ((self.lw, 0), (self.sum_acc, 0), (self.cnt, 0), (self.diverging, False),
                       (self.active, True), (self.n, 1)):
            if mask is None:
                buf.fill_(x)
            else:
                buf.masked_fill_(mask, x)

    def leaf(self, value_and_grad_fn: VG, dir_pos: Tensor, swap_u: Tensor, take_u: Tensor) -> None:
        """The leaf at n for every chain, in place, from the leaf's draws
        (``TorchNutsRandom.leaf``); every n then advances by one.  On CUDA
        the bookkeeping runs in kernel K7, its head before the potential and
        its tail after it; elsewhere ``plain_leaf`` runs it."""
        if self.leaf_args is None:
            self.plain_leaf(value_and_grad_fn, dir_pos, swap_u, take_u)
            return
        from ..ops.nuts_leaf import NUTS_LEAF

        dtype = self.z.dtype
        z_new = NUTS_LEAF.head(self.leaf_args, self.n, dir_pos.to(torch.bool).contiguous())
        val_new, grad_new = value_and_grad_fn(z_new)
        NUTS_LEAF.tail(self.leaf_args, self.n, val_new.to(dtype).contiguous(),
                       grad_new.to(dtype).contiguous(), swap_u.to(dtype).contiguous(),
                       take_u.to(dtype).contiguous())

    def plain_leaf(self, value_and_grad_fn: VG, dir_pos: Tensor, swap_u: Tensor,
                   take_u: Tensor) -> None:
        """``leaf`` in PyTorch ops: what the CPU runs, and what K7 is held
        to on the card."""
        eps, inv_mass = self.eps, self.inv_mass
        flags = self.flags[self.n]
        start, is_end, checks = flags[:, 0], flags[:, 1], flags[:, 2:].T

        # --- subtree start: per-chain direction + moving end + reset ------
        torch.where(start, torch.where(dir_pos, 1.0, -1.0).to(self.dirn.dtype), self.dirn,
                    out=self.dirn)
        take_right = self.dirn > 0
        torch.where(_col(start), torch.where(_col(take_right), self.ends[1], self.ends[0]),
                    self.mov, out=self.mov)
        self.s_lw.masked_fill_(start, -math.inf)
        self.s_cum.masked_fill_(_col(start), 0.0)
        self.s_failed.masked_fill_(start, False)

        # --- one batched leapfrog from the moving end ---------------------
        eps_c = (eps * self.dirn)[:, None]
        half = 0.5 * eps_c
        r_half = self.mov[2] + half * self.mov[1]
        z_new = self.mov[0] + eps_c * inv_mass[None, :] * r_half
        val_new, grad_new = value_and_grad_fn(z_new)
        r_new = r_half + half * grad_new

        # an energy that is not a number counts as +inf (a divergence)
        h = torch.nan_to_num(_ke(r_new, inv_mass) - val_new, nan=math.inf, posinf=math.inf,
                             neginf=-math.inf)
        lw_leaf = self.h0 - h
        dvg = lw_leaf < -self.max_delta_energy  # h - h0 > max_delta_energy, exactly
        live = self.active & ~self.s_failed

        acc = torch.exp(torch.clamp(lw_leaf, max=0.0))
        self.sum_acc += torch.where(live, acc, 0.0)
        self.cnt += live

        # --- checkpoints (store BEFORE adding this leaf's momentum): a
        # chain's row of its slot, one slot for every chain or one each ----
        slot = self.slot[self.n].view(1, -1, 1).expand(1, *r_new.shape)
        self.r_ck.scatter_(0, slot, r_new[None])
        self.rs_ck.scatter_(0, slot, self.s_cum[None])

        # --- progressive multinomial within the subtree -------------------
        s_cum_new = self.s_cum + r_new
        s_lw_new = torch.logaddexp(self.s_lw, lw_leaf)
        swap = live & (swap_u < torch.exp(lw_leaf - s_lw_new))
        point = torch.stack([z_new, grad_new, r_new])
        torch.where(_col(swap), point[:2], self.sp, out=self.sp)
        torch.where(swap, val_new, self.sp_val, out=self.sp_val)

        # --- U-turn checks vs the checkpoint slots [lo, pc) (odd leaves) --
        kdim = checks.shape[0]
        rho = s_cum_new[None] - self.rs_ck[:kdim]  # [kdim, C, d]
        dot_a = torch.sum(rho * self.r_ck[:kdim] * inv_mass, -1)
        dot_b = torch.sum(rho * (r_new * inv_mass[None, :])[None], -1)
        turn_sub = (((dot_a <= 0.0) | (dot_b <= 0.0)) & checks).any(0)
        new_fail = live & (dvg | turn_sub)
        self.s_failed |= new_fail
        self.diverging |= live & dvg

        upd = live & ~new_fail
        torch.where(upd, s_lw_new, self.s_lw, out=self.s_lw)
        torch.where(upd[:, None], s_cum_new, self.s_cum, out=self.s_cum)
        torch.where(_col(upd), point, self.mov, out=self.mov)

        # --- subtree end: merge into the global tree ----------------------
        merging = is_end & upd
        take = merging & (take_u < torch.exp(torch.clamp(self.s_lw - self.lw, max=0.0)))
        torch.where(_col(take), self.sp, self.prop, out=self.prop)
        torch.where(take, self.sp_val, self.prop_val, out=self.prop_val)
        sides = torch.stack([~take_right, take_right]) & merging
        torch.where(sides[:, None, :, None], self.mov[None], self.ends, out=self.ends)
        torch.where(merging[:, None], self.r_sum + self.s_cum, self.r_sum, out=self.r_sum)
        torch.where(merging, torch.logaddexp(self.lw, self.s_lw), self.lw, out=self.lw)
        full_turn = _turning(self.r_sum, self.ends[0, 2], self.ends[1, 2], inv_mass)
        # deactivate: a failed leaf, a failed subtree at its end (discarded)
        # or a full-tree U-turn
        self.active &= ~(new_fail | (is_end & self.s_failed) | (merging & full_turn))
        self.n += 1

    def transition(self, value_and_grad_fn: VG, z: Tensor, val: Tensor, grad: Tensor,
                   eps: Tensor, inv_mass: Tensor, rng) -> Transition:
        """One NUTS draw for all chains from (z, val, grad) (see
        ``nuts_transition_batched``)."""
        for buf, x in ((self.z, z), (self.val, val), (self.grad, grad), (self.eps, eps),
                       (self.inv_mass, inv_mass)):
            buf.copy_(x)
        graphed = z.device.type == "cuda" and isinstance(rng, TorchNutsRandom)
        if not graphed or self.graphs is False:
            leaves, syncs = self._walk(value_and_grad_fn, rng, None)
            replayed = 0
        elif self.graphs is None:
            # the first transition at this shape: eagerly, on the stream the
            # capture takes (its warm-up: the scratch, the handles and the
            # kernels it will replay are those of that stream), then capture
            main, side = torch.cuda.current_stream(z.device), _capture_stream(z.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                leaves, syncs = self._walk(value_and_grad_fn, rng, None)
            main.wait_stream(side)
            self.graphs = self._capture(value_and_grad_fn, side)
            replayed = 0
        else:
            # the graphs draw from the tree's generator, given the caller's
            # state for the transition and handing it back after
            gen = rng.generator
            if gen is None:
                gen = torch.cuda.default_generators[z.device.index]
            self.gen.set_state(gen.get_state())
            leaves, syncs = self._walk(value_and_grad_fn, rng, self.graphs)
            gen.set_state(self.gen.get_state())
            replayed = leaves

        tr = _metrics._tracer
        if tr is not None:
            _count_tree(tr, leaves, self.cnt, self.r_ck.shape[0] - 1)
            tr.count("nuts.graph_leaves", replayed)
            tr.count("nuts.eager_leaves", leaves - replayed)
            tr.count("nuts.kernel_leaves", 0 if self.leaf_args is None else leaves)
            tr.count("nuts.tree_state_bytes", self.state_bytes)
        accept_prob = self.sum_acc / torch.clamp(self.cnt, min=1.0)
        return Transition(self.prop[0].clone(), self.prop_val.clone(), self.prop[1].clone(),
                          accept_prob, self.diverging.clone(), leaves, torch.mean(self.cnt),
                          syncs, replayed)

    def _walk(self, value_and_grad_fn: VG, rng, graphs) -> Tuple[int, int]:
        """The start and the leaves until every chain has stopped or the
        tree is full, replayed from ``graphs`` (start, leaf) or run eagerly
        where it is None; returns (leaves, host syncs)."""
        tr = _metrics._tracer
        c = self.val.shape[0]
        if graphs is None:
            self.start(rng.momentum(self.z))
        else:
            graphs[0].replay()
        n = 1
        syncs = 0
        while n < self.max_n:
            syncs += 1
            if tr is not None:
                t_sync = time.perf_counter_ns()
            if not bool(self.active.any()):
                if tr is not None:
                    tr.span("nuts.sync", t_sync, time.perf_counter_ns())
                break
            if tr is not None:
                t_leaf = time.perf_counter_ns()
            if graphs is None:
                self.leaf(value_and_grad_fn, *rng.leaf(n, c, self.val))
            else:
                graphs[1].replay()
                for kernel, count in self.launched:
                    kernel.launches += count
            if tr is not None:
                tr.span("nuts.sync", t_sync, t_leaf,
                        parent=tr.span("nuts.leaf", t_sync, time.perf_counter_ns()))
            n += 1
        return n - 1, syncs

    def _capture(self, value_and_grad_fn: VG, stream):
        """(start graph, leaf graph) captured on ``stream`` over the tree's
        buffers, drawing from the tree's own generator; False where the
        card cannot capture them (a value+grad that waits on it), and the
        tree runs eagerly from then on.  The port's kernels count in
        ``launches`` the times they ran: a capture runs none, so the
        launches it recorded are taken back and ``launched`` adds them at
        every replay of the leaf."""
        from ..ops import kernel_wrappers

        t0 = time.perf_counter_ns()
        kernels = kernel_wrappers().values()
        before = [k.launches for k in kernels]
        self.gen = torch.Generator(device=stream.device)
        rng = TorchNutsRandom(self.gen)
        graphs = (torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph())
        c = self.val.shape[0]
        try:
            for graph, body in zip(graphs, (
                    lambda: self.start(rng.momentum(self.z)),
                    lambda: self.leaf(value_and_grad_fn, *rng.leaf(0, c, self.val)))):
                graph.register_generator_state(self.gen)
                # thread_local: another thread's CUDA calls do not break it
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                    body()
        except RuntimeError:
            graphs = False
            # a capture registers the default generator as capturing and
            # only a capture that ends clears it: the failed one did not, so
            # a capture that ends does, else the next default draw would
            # raise; it is never replayed
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
                self.n.add_(0)  # one node: an empty graph warns
        self.launched = [(k, k.launches - b) for k, b in zip(kernels, before) if k.launches > b]
        for k, count in self.launched:
            k.launches -= count
        torch.cuda.synchronize(stream.device)
        tr = _metrics._tracer
        if tr is not None:
            tr.span("nuts.leaf_capture", t0, time.perf_counter_ns())
        return graphs


def _tree(value_and_grad_fn: VG, z: Tensor, max_depth: int,
          max_delta_energy: float) -> _NutsTree:
    """The lockstep tree over ``value_and_grad_fn`` at z's shape: kept in
    the function's ``lockstep_trees`` where it has them (``sample()``'s
    cached value+grad functions do, so a later call replays the graphs of
    the first), else a new one, for the caller to hold while it runs."""
    trees = getattr(value_and_grad_fn, "lockstep_trees", None)
    key = (*z.shape, z.dtype, z.device, max_depth, max_delta_energy)
    if trees is None or key not in trees:
        tree = _NutsTree(*z.shape, z.dtype, z.device, max_depth, max_delta_energy)
        if trees is None:
            return tree
        trees[key] = tree
    return trees[key]


def nuts_transition_batched(
    value_and_grad_fn: VG,
    z: Tensor,
    val: Tensor,
    grad: Tensor,
    eps: Tensor,
    inv_mass: Tensor,
    rng,
    max_depth: int = 10,
    max_delta_energy: float = 1000.0,
) -> Transition:
    """One NUTS draw for all chains.  value/grad are of the LOG posterior.
    ``rng`` provides the randomness (see ``TorchNutsRandom``).  The tree is
    ``_NutsTree``'s, kept with the function where it can be (``_tree``)."""
    tree = _tree(value_and_grad_fn, z, max_depth, max_delta_energy)
    return tree.transition(value_and_grad_fn, z, val, grad, eps, inv_mass, rng)


def _count_tree(tr, leaves: int, cnt: Tensor, kdim: int) -> None:
    """Adds a lockstep tree to the recorder's counters: its leaves, the sum
    of its chains' live leaves, and each chain's own depth.  A chain's live
    leaves fill every doubling before the one it stopped in, so its depth
    (the doublings it ran) is the number of powers of two up to its count;
    compared in floats (exact for counts under 2**24), so that nothing is
    read from the device."""
    tr.count("nuts.leaves", leaves)
    tr.count("nuts.live_leaves", cnt.to(torch.int64).sum())
    pow2 = torch.exp2(torch.arange(kdim, device=cnt.device, dtype=cnt.dtype))
    depth = (cnt[:, None] >= pow2[None, :]).sum(1)
    tr.count("nuts.depth_hist",
             (depth[:, None] == torch.arange(kdim, device=cnt.device)[None, :]).sum(0))


def _warmup_windows(in_slow, window_end) -> list:
    """[(start, stop)] iterations of each adaptation window of a warmup
    schedule: the initial buffer, each slow window, the terminal buffer."""
    cuts = [i + 1 for i in range(len(in_slow) - 1)
            if window_end[i] or in_slow[i] != in_slow[i + 1]]
    edges = [0] + cuts + [len(in_slow)] if len(in_slow) else []
    return list(zip(edges, edges[1:]))


def _pipelined_sampling(
    value_and_grad_fn: VG,
    z: Tensor,
    val: Tensor,
    grad: Tensor,
    eps: Tensor,
    inv_mass: Tensor,
    rng,
    num_samples: int,
    max_depth: int,
    max_delta_energy: float,
    lookahead: int = 16,
):
    """The sampling phase with per-chain draw pipelining: each chain
    refreshes its momentum and starts its next draw in the iteration after
    its U-turn, so the iterations approach S times the mean tree instead
    of the sum over draws of the deepest chain's tree.

    A chain that is ``B = max(2, min(lookahead, S))`` draws ahead of the
    row all chains have passed (``flushed``, which moves at most one row an
    iteration, as JAX's ring flush does) idles; the slowest chain never
    does.  ``rng.iteration(it, z)`` gives iteration ``it``'s numbers.
    Returns (samples [C, S, d], accept [C, S], diverging [C, S],
    iterations, mean live leapfrogs a draw [S], host syncs).

    An iteration is one leaf of a ``_NutsTree`` whose n holds a leaf index
    per chain: the chains that start a draw take the tree's start, masked
    to them, then every chain takes its own leaf; a chain whose tree ended
    writes its draw, moves to its proposal (the tree's inputs) and waits at
    n = 0 for its next start.  A waiting chain reads leaf 1's row and is
    not live: the leaf's writes for it are written again, by its next start
    and first leaf, before they are read."""
    c, d = z.shape
    dtype, dev = z.dtype, z.device
    s_len = num_samples
    ring = max(2, min(int(lookahead), s_len))
    tree = _NutsTree(c, d, dtype, dev, max_depth, max_delta_energy)
    for buf, x in ((tree.z, z), (tree.val, val), (tree.grad, grad), (tree.eps, eps),
                   (tree.inv_mass, inv_mass)):
        buf.copy_(x)
    chains = torch.arange(c, device=dev)
    draw = torch.zeros((c,), dtype=torch.int64, device=dev)
    tree.n = torch.zeros_like(draw)  # a leaf index per chain; 0: between draws
    flushed = torch.zeros((), dtype=torch.int64, device=dev)
    # outputs; column s_len takes the writes of chains that finish nothing
    zs = torch.zeros((c, s_len + 1, d), dtype=dtype, device=dev)
    aps = torch.zeros((c, s_len + 1), dtype=dtype, device=dev)
    dvgs = torch.zeros((c, s_len + 1), dtype=torch.bool, device=dev)
    cnts = torch.zeros((c, s_len + 1), dtype=dtype, device=dev)
    it = 0
    syncs = 0
    tr = _metrics._tracer
    while True:
        working = draw < s_len  # chains with draws left
        syncs += 1
        if tr is not None:
            t_sync = time.perf_counter_ns()
        if not bool(working.any()):
            if tr is not None:
                tr.span("nuts.sync", t_sync, time.perf_counter_ns())
            break
        if tr is not None:
            t_leaf = time.perf_counter_ns()
        mom, dir_pos, swap_u, take_u = rng.iteration(it, z)
        tree.start(mom, (tree.n == 0) & working & (draw - flushed < ring))
        in_tree = tree.n > 0
        tree.leaf(value_and_grad_fn, dir_pos, swap_u, take_u)

        # --- a finished chain writes its draw and waits at n = 0 ----------
        going = tree.active & (tree.n < tree.max_n)
        finished = in_tree & ~going
        row = torch.where(finished, draw, s_len)
        zs[chains, row] = tree.prop[0]
        aps[chains, row] = tree.sum_acc / torch.clamp(tree.cnt, min=1.0)
        dvgs[chains, row] = tree.diverging
        cnts[chains, row] = tree.cnt
        draw += finished
        flushed += draw.min() > flushed
        torch.where(_col(finished), tree.prop[0], tree.z, out=tree.z)
        torch.where(_col(finished), tree.prop[1], tree.grad, out=tree.grad)
        torch.where(finished, tree.prop_val, tree.val, out=tree.val)
        tree.n.masked_fill_(~going, 0)
        tree.active &= going
        it += 1
        if tr is not None:
            tr.span("nuts.sync", t_sync, t_leaf,
                    parent=tr.span("nuts.leaf", t_sync, time.perf_counter_ns()))
    if tr is not None:
        # an iteration is one leaf over every chain; a chain's live leaves
        # are the sum of its draws' counts
        tr.count("nuts.leaves", it)
        tr.count("nuts.kernel_leaves", 0 if tree.leaf_args is None else it)
        tr.count("nuts.live_leaves", cnts[:, :s_len].to(torch.int64).sum())
    return (zs[:, :s_len], aps[:, :s_len], dvgs[:, :s_len], it,
            torch.mean(cnts[:, :s_len], dim=0), syncs)


def nuts_batched(
    value_and_grad_fn: VG,
    z0: Tensor,
    num_warmup: int,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    max_delta_energy: float = 1000.0,
    rng=None,
    inv_mass0: Optional[Tensor] = None,
    pipeline: bool = False,
    lookahead: int = 16,
    axis=None,
) -> VectorizedNUTSResult:
    """Full vectorized-NUTS run with shared warmup adaptation: dual-averaged
    step size on the mean accept probability over chains, and a diagonal
    mass from cross-chain moments at each window end, starting from
    ``inv_mass0`` (ones when None); over the ranks of ``axis`` too when
    the chains are sharded.  Warmup is lockstep; with ``pipeline``
    the draws come from ``_pipelined_sampling``, whose per-draw iteration
    count is reported as the amortised iterations a draw."""
    c, d = z0.shape
    dtype, dev = z0.dtype, z0.device
    tr = _metrics._tracer
    rng = TorchNutsRandom(generator) if rng is None else rng
    z, (val, grad) = z0, value_and_grad_fn(z0)
    in_slow, window_end = build_warmup_schedule(num_warmup)
    tree = _tree(value_and_grad_fn, z0, max_depth, max_delta_energy)

    def transition(z, val, grad, eps, inv_mass):
        return tree.transition(value_and_grad_fn, z, val, grad, eps, inv_mass, rng)

    da = da_init(torch.tensor(init_step_size, dtype=dtype, device=dev))
    inv_mass = (torch.ones((d,), dtype=dtype, device=dev) if inv_mass0 is None
                else torch.as_tensor(inv_mass0, dtype=dtype, device=dev))
    s1 = torch.zeros((d,), dtype=dtype, device=dev)
    s2 = torch.zeros_like(s1)
    n_acc = 0
    warmup_leapfrog = 0
    syncs = 0
    graph_leaves = 0
    if tr is not None:
        warmup = tr.open("nuts.warmup")
    for start, stop in _warmup_windows(in_slow, window_end):
        if tr is not None:
            window, leaves0 = tr.open("nuts.window"), warmup_leapfrog
        for i in range(start, stop):
            t = transition(z, val, grad, torch.exp(da.log_step), inv_mass)
            z, val, grad = t.z, t.val, t.grad
            warmup_leapfrog += t.num_leaves
            syncs += t.host_syncs
            graph_leaves += t.graph_leaves
            da = da_update(da, pmean_if(torch.mean(t.accept_prob), axis),
                           target_accept=target_accept)
            if in_slow[i]:
                s1 = s1 + torch.sum(z, dim=0)
                s2 = s2 + torch.sum(z * z, dim=0)
                n_acc += c
            if window_end[i]:
                s1g, s2g = psum_if(torch.stack([s1, s2]), axis)
                inv_mass = diag_mass_update(s1g, s2g, n_acc * (1 if axis is None else axis.size))
                s1, s2, n_acc = torch.zeros_like(s1), torch.zeros_like(s2), 0
                da = da_restart(da)
        if tr is not None:
            tr.close(window, iterations=stop - start, leaves=warmup_leapfrog - leaves0)
    if tr is not None:
        tr.close(warmup, iterations=num_warmup, leaves=warmup_leapfrog)
    eps_final = (torch.exp(da.log_step_avg) if num_warmup > 0
                 else torch.tensor(init_step_size, dtype=dtype, device=dev))

    t_sampling = time.perf_counter_ns()
    if tr is not None:
        draws = tr.open("nuts.draws", t_sampling)
    if pipeline:
        zs, aps, dvgs, iters, c_leaps, pipe_syncs = _pipelined_sampling(
            value_and_grad_fn, z, val, grad, eps_final, inv_mass, rng, num_samples,
            max_depth, max_delta_energy, lookahead=lookahead,
        )
        t_end = time.perf_counter_ns()
        if tr is not None:
            tr.close(draws, t_end, leaves=iters)
        return VectorizedNUTSResult(
            samples=zs, accept_prob=aps, diverging=dvgs,
            num_leapfrog=torch.full((num_samples,), -(-iters // max(num_samples, 1)), dtype=torch.int64),
            step_size=eps_final, inv_mass=inv_mass, warmup_leapfrog=warmup_leapfrog,
            chain_leapfrog=c_leaps, host_syncs=syncs + pipe_syncs,
            sampling_seconds=(t_end - t_sampling) * 1e-9, graph_leaves=graph_leaves,
        )

    zs = torch.empty((num_samples, c, d), dtype=dtype, device=dev)
    aps = torch.empty((num_samples, c), dtype=dtype, device=dev)
    dvgs = torch.empty((num_samples, c), dtype=torch.bool, device=dev)
    c_leaps = torch.empty((num_samples,), dtype=dtype, device=dev)
    n_leaps = []
    for s in range(num_samples):
        t = transition(z, val, grad, eps_final, inv_mass)
        z, val, grad = t.z, t.val, t.grad
        zs[s], aps[s], dvgs[s], c_leaps[s] = z, t.accept_prob, t.diverging, t.mean_live
        n_leaps.append(t.num_leaves)
        syncs += t.host_syncs
        graph_leaves += t.graph_leaves
    num_leapfrog = torch.tensor(n_leaps, dtype=torch.int64)
    t_end = time.perf_counter_ns()
    if tr is not None:
        tr.close(draws, t_end, leaves=sum(n_leaps))
    return VectorizedNUTSResult(
        samples=zs.transpose(0, 1),
        accept_prob=aps.transpose(0, 1),
        diverging=dvgs.transpose(0, 1),
        num_leapfrog=num_leapfrog,
        step_size=eps_final,
        inv_mass=inv_mass,
        warmup_leapfrog=warmup_leapfrog,
        chain_leapfrog=c_leaps,
        host_syncs=syncs,
        sampling_seconds=(t_end - t_sampling) * 1e-9,
        graph_leaves=graph_leaves,
    )
