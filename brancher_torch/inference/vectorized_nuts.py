"""Vectorized (chain-batched) NUTS: all chains advance in lockstep, or
draw-pipelined in the sampling phase.

Counterpart of ``brancher_tpu/inference/vectorized_nuts.py``:
``nuts_transition_batched`` (lines 100-311), ``_pipelined_sampling``
(lines 314-728) and ``nuts_batched`` (lines 729-839).

The tree's doubling schedule is deterministic and shared by every chain:
leaf n belongs to doubling floor(log2 n) at in-subtree position
m = n - 2^depth.  In the JAX package that schedule is computed on the
device inside a ``while_loop``; here the loop runs on the host, so n,
depth, m, the checkpoint slot popcount(m) and the U-turn slot range are
Python ints and the schedule's branches are Python ``if``s.  Only the
per-chain direction, proposal swaps and stopping are tensors.  The loop
condition ``any(active)`` costs one host sync per leaf.

The pipelined sampling phase (``NUTS(pipelined=True)``) gives each chain
its own leaf index, so the schedule is per chain there: [C] tensors, with
popcount and floor(log2) read from small tables.  A chain refreshes its
momentum and starts its next draw in the iteration after its U-turn; a
chain ``lookahead`` draws ahead of the slowest idles (JAX's ring
backpressure, kept as a counter: the ring itself only dodged XLA's
scatter copies inside a while loop, so each completed draw is written
straight into the output by index).  One host sync an iteration.

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
``nuts.sync``; ``nuts.leaves``, ``nuts.live_leaves``, ``nuts.depth_hist``:
``metrics.tracing``'s docstring).  A transition reads the recorder once;
off, each point in its loop is one ``is None`` test.  The counters are
summed on the device and change no number the engine computes.
"""
from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import metrics as _metrics
from .adaptation import (
    build_warmup_schedule, da_init, da_restart, da_update, diag_mass_update, pmean_if, psum_if,
)

Tensor = torch.Tensor
VG = Callable[[Tensor], Tuple[Tensor, Tensor]]


class TorchNutsRandom:
    """The randomness of NUTS transitions, drawn from a torch.Generator.

    ``momentum(z)`` returns standard normals shaped like z; ``leaf(n, c)``
    returns, for leaf n of the current tree, (direction is +1 [C] bool,
    swap uniforms [C], take uniforms [C]).  The JAX package draws the
    direction as ``bernoulli(0.5)``, i.e. a uniform below one half.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def momentum(self, z: Tensor) -> Tensor:
        return torch.randn(z.shape, generator=self.generator, device=z.device, dtype=z.dtype)

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


def _ke(r: Tensor, inv_mass: Tensor) -> Tensor:
    return 0.5 * torch.sum(r * r * inv_mass[None, :], dim=-1)


def _turning(rho: Tensor, r_a: Tensor, r_b: Tensor, inv_mass: Tensor) -> Tensor:
    va = r_a * inv_mass[None, :]
    vb = r_b * inv_mass[None, :]
    return (torch.sum(rho * va, -1) <= 0.0) | (torch.sum(rho * vb, -1) <= 0.0)


def _sel(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """where(mask, a, b) with a [C] mask over [C] or [C, d] values."""
    return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)


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
    ``rng`` provides the randomness (see ``TorchNutsRandom``)."""
    c, d = z.shape
    kdim = max_depth + 1
    tr = _metrics._tracer
    r0 = rng.momentum(z) / torch.sqrt(inv_mass)[None, :]
    h0 = -val + _ke(r0, inv_mass)

    left_z, left_r, left_grad = z, r0, grad
    right_z, right_r, right_grad = z, r0, grad
    prop_z, prop_val, prop_grad = z, val, grad
    lw = torch.zeros_like(val)
    r_sum = r0
    m_z, m_r, m_grad = z, r0, grad
    s_lw = torch.full_like(val, -math.inf)
    s_cum = torch.zeros_like(z)
    sp_z, sp_val, sp_grad = z, val, grad
    s_failed = torch.zeros((c,), dtype=torch.bool, device=z.device)
    # checkpoint stacks, depth-major [kdim, C, d]; written in place (they
    # belong to this transition alone)
    r_ck = torch.zeros((kdim, c, d), dtype=z.dtype, device=z.device)
    rs_ck = torch.zeros_like(r_ck)
    dirn = torch.ones_like(val)
    take_right = dirn > 0
    active = torch.ones_like(s_failed)
    diverging = torch.zeros_like(s_failed)
    sum_acc = torch.zeros_like(val)
    cnt = torch.zeros_like(val)

    max_n = 2**max_depth
    n = 1
    syncs = 0
    while n < max_n:
        syncs += 1
        if tr is not None:
            t_sync = time.perf_counter_ns()
        if not bool(active.any()):
            if tr is not None:
                tr.span("nuts.sync", t_sync, time.perf_counter_ns())
            break
        if tr is not None:
            t_leaf = time.perf_counter_ns()
        # static-schedule metadata (host ints)
        depth = n.bit_length() - 1
        m = n - (1 << depth)
        is_end = m == (1 << depth) - 1
        pc = bin(m).count("1")
        t_ones = bin((m ^ (m + 1)) >> 1).count("1")
        even = m % 2 == 0
        dir_pos, swap_u, take_u = rng.leaf(n, c, val)

        # --- subtree start: per-chain direction + moving end + reset ------
        if m == 0:
            dirn = torch.where(dir_pos, 1.0, -1.0).to(val.dtype)
            take_right = dirn > 0
            m_z = _sel(take_right, right_z, left_z)
            m_r = _sel(take_right, right_r, left_r)
            m_grad = _sel(take_right, right_grad, left_grad)
            s_lw = torch.full_like(val, -math.inf)
            s_cum = torch.zeros_like(z)
            s_failed = torch.zeros_like(s_failed)

        # --- one batched leapfrog from the moving end ---------------------
        eps_c = (eps * dirn)[:, None]
        r_half = m_r + 0.5 * eps_c * m_grad
        z_new = m_z + eps_c * inv_mass[None, :] * r_half
        val_new, grad_new = value_and_grad_fn(z_new)
        r_new = r_half + 0.5 * eps_c * grad_new

        h = -val_new + _ke(r_new, inv_mass)
        h = torch.where(torch.isnan(h), math.inf, h)
        lw_leaf = h0 - h
        dvg = (h - h0) > max_delta_energy
        live = active & ~s_failed

        acc = torch.exp(torch.clamp(lw_leaf, max=0.0))
        sum_acc = sum_acc + torch.where(live, acc, 0.0)
        cnt = cnt + live.to(cnt.dtype)

        # --- checkpoints (store BEFORE adding this leaf's momentum) -------
        if even:
            r_ck[pc] = r_new
            rs_ck[pc] = s_cum

        # --- progressive multinomial within the subtree -------------------
        s_cum_new = s_cum + r_new
        s_lw_new = torch.logaddexp(s_lw, lw_leaf)
        swap = live & (swap_u < torch.exp(lw_leaf - s_lw_new))
        sp_z = _sel(swap, z_new, sp_z)
        sp_val = _sel(swap, val_new, sp_val)
        sp_grad = _sel(swap, grad_new, sp_grad)

        # --- U-turn checks vs the checkpoint slots [pc - t_ones, pc) ------
        if even:
            new_fail = live & dvg
        else:
            lo = pc - t_ones
            rho = s_cum_new[None] - rs_ck[lo:pc]  # [K', C, d]
            dot_a = torch.sum(rho * r_ck[lo:pc] * inv_mass, -1)
            dot_b = torch.sum(rho * (r_new * inv_mass[None, :])[None], -1)
            turn_sub = ((dot_a <= 0.0) | (dot_b <= 0.0)).any(0)
            new_fail = live & (dvg | turn_sub)
        s_failed = s_failed | new_fail
        diverging = diverging | (live & dvg)

        upd = live & ~new_fail
        s_lw = _sel(upd, s_lw_new, s_lw)
        s_cum = _sel(upd, s_cum_new, s_cum)
        m_z = _sel(upd, z_new, m_z)
        m_r = _sel(upd, r_new, m_r)
        m_grad = _sel(upd, grad_new, m_grad)

        active = active & ~new_fail
        if is_end:
            # --- subtree end: merge into the global tree ------------------
            merging = upd
            take = merging & (take_u < torch.exp(torch.clamp(s_lw - lw, max=0.0)))
            prop_z = _sel(take, sp_z, prop_z)
            prop_val = _sel(take, sp_val, prop_val)
            prop_grad = _sel(take, sp_grad, prop_grad)
            right_sel = merging & take_right
            left_sel = merging & ~take_right
            right_z = _sel(right_sel, m_z, right_z)
            right_r = _sel(right_sel, m_r, right_r)
            right_grad = _sel(right_sel, m_grad, right_grad)
            left_z = _sel(left_sel, m_z, left_z)
            left_r = _sel(left_sel, m_r, left_r)
            left_grad = _sel(left_sel, m_grad, left_grad)
            r_sum = _sel(merging, r_sum + s_cum, r_sum)
            lw = _sel(merging, torch.logaddexp(lw, s_lw), lw)
            full_turn = _turning(r_sum, left_r, right_r, inv_mass)
            # deactivate: failed subtree (discarded) or full-tree U-turn
            active = active & ~s_failed & ~(merging & full_turn)
        if tr is not None:
            tr.span("nuts.sync", t_sync, t_leaf,
                    parent=tr.span("nuts.leaf", t_sync, time.perf_counter_ns()))
        n += 1

    if tr is not None:
        _count_tree(tr, n - 1, cnt, kdim)
    accept_prob = sum_acc / torch.clamp(cnt, min=1.0)
    return Transition(prop_z, prop_val, prop_grad, accept_prob, diverging,
                      n - 1, torch.mean(cnt), syncs)


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

    Points are stacked [3, C, d] tensors of (z, grad, r), so that one
    select moves a whole point (the host issues every op of an iteration;
    fewer, larger ops cost it less): ``ends`` [2, 3, C, d] holds the left
    and right ends, ``mov`` the subtree's moving end, ``prop`` and ``sp``
    the (z, grad) of the tree's and the subtree's proposals, ``cur`` the
    chain's position."""
    c, d = z.shape
    dtype, dev = z.dtype, z.device
    kdim = max_depth + 1
    max_n = 2**max_depth
    s_len = num_samples
    ring = max(2, min(int(lookahead), s_len))
    # popcount and floor(log2) of every leaf index a tree reaches
    popcount = torch.tensor([bin(i).count("1") for i in range(max_n + 1)], device=dev)
    log2 = torch.tensor([max(i, 1).bit_length() - 1 for i in range(max_n + 1)], device=dev)
    slots = torch.arange(kdim, device=dev)[:, None]
    chains = torch.arange(c, device=dev)
    false_c = torch.zeros((c,), dtype=torch.bool, device=dev)

    def col(mask):  # a [C] mask over stacked [k, C, d] points
        return mask[:, None]

    draw = torch.zeros((c,), dtype=torch.int64, device=dev)
    n = torch.zeros_like(draw)  # 0: start a fresh draw
    flushed = torch.zeros((), dtype=torch.int64, device=dev)
    cur = torch.stack([z, grad])
    point = torch.stack([z, grad, torch.zeros_like(z)])
    ends = torch.stack([point, point])
    mov = point
    prop, sp = cur, cur
    prop_val, sp_val = val, val
    h0 = torch.zeros_like(val)
    lw, r_sum = torch.zeros_like(val), torch.zeros_like(z)
    s_lw, s_cum = torch.full_like(val, -math.inf), torch.zeros_like(z)
    s_failed = false_c
    # checkpoint stacks, depth-major; row kdim takes the writes of chains
    # that store nothing this iteration
    r_ck = torch.zeros((kdim + 1, c, d), dtype=dtype, device=dev)
    rs_ck = torch.zeros_like(r_ck)
    dirn = torch.ones_like(val)
    active, dvg_draw = false_c, false_c
    sum_acc, cnt = torch.zeros_like(val), torch.zeros_like(val)
    # outputs; column s_len takes the writes of chains that finish nothing
    zs = torch.zeros((c, s_len + 1, d), dtype=dtype, device=dev)
    aps = torch.zeros((c, s_len + 1), dtype=dtype, device=dev)
    dvgs = torch.zeros((c, s_len + 1), dtype=torch.bool, device=dev)
    cnts = torch.zeros((c, s_len + 1), dtype=dtype, device=dev)
    it = 0
    syncs = 0
    while True:
        working = draw < s_len  # chains with draws left
        syncs += 1
        if not bool(working.any()):
            break
        mom, dir_pos, swap_u, take_u = rng.iteration(it, z)

        # --- per-chain draw start: refresh momentum, reset the tree ------
        starting = (n == 0) & working & (draw - flushed < ring)
        r0 = mom / torch.sqrt(inv_mass)[None, :]
        h0 = torch.where(starting, -val + _ke(r0, inv_mass), h0)
        ends = torch.where(col(starting), torch.cat([cur, r0[None]])[None], ends)
        prop = torch.where(col(starting), cur, prop)
        prop_val = torch.where(starting, val, prop_val)
        lw = torch.where(starting, 0.0, lw)
        r_sum = _sel(starting, r0, r_sum)
        active = active | starting
        dvg_draw = dvg_draw & ~starting
        sum_acc = torch.where(starting, 0.0, sum_acc)
        cnt = torch.where(starting, 0.0, cnt)
        n = torch.where(starting, 1, n)  # leaf 1 runs this iteration

        # --- per-chain schedule ------------------------------------------
        n_safe = torch.clamp(n, min=1)
        depth = log2[n_safe]
        m = n_safe - (1 << depth)
        is_start = m == 0
        is_end = m == (1 << depth) - 1
        pc = popcount[m]
        lo = pc - popcount[(m ^ (m + 1)) >> 1]
        even = m % 2 == 0

        # --- subtree start: per-chain direction + moving end + reset ------
        dirn = torch.where(is_start, torch.where(dir_pos, 1.0, -1.0).to(dtype), dirn)
        take_right = dirn > 0
        mov = torch.where(col(is_start), torch.where(col(take_right), ends[1], ends[0]), mov)
        s_lw = torch.where(is_start, -math.inf, s_lw)
        s_cum = torch.where(is_start[:, None], 0.0, s_cum)
        s_failed = s_failed & ~is_start

        # --- one batched leapfrog from the moving end ---------------------
        eps_c = (eps * dirn)[:, None]
        r_half = mov[2] + 0.5 * eps_c * mov[1]
        z_new = mov[0] + eps_c * inv_mass[None, :] * r_half
        val_new, grad_new = value_and_grad_fn(z_new)
        r_new = r_half + 0.5 * eps_c * grad_new
        leaf = torch.stack([z_new, grad_new, r_new])
        h = -val_new + _ke(r_new, inv_mass)
        h = torch.where(torch.isnan(h), math.inf, h)
        lw_leaf = h0 - h
        dvg = (h - h0) > max_delta_energy
        live = active & ~s_failed & working
        sum_acc = sum_acc + torch.where(live, torch.exp(torch.clamp(lw_leaf, max=0.0)), 0.0)
        cnt = cnt + live.to(cnt.dtype)

        # --- checkpoints: slot popcount(m) of even leaves -----------------
        slot = torch.where(even & live, pc, kdim)
        r_ck[slot, chains] = r_new
        rs_ck[slot, chains] = s_cum

        # --- progressive multinomial within the subtree -------------------
        s_cum_new = s_cum + r_new
        s_lw_new = torch.logaddexp(s_lw, lw_leaf)
        swap = live & (swap_u < torch.exp(lw_leaf - s_lw_new))
        sp = torch.where(col(swap), leaf[:2], sp)
        sp_val = torch.where(swap, val_new, sp_val)

        # --- U-turn checks vs the slots [lo, pc) (odd leaves) -------------
        rho = s_cum_new[None] - rs_ck[:kdim]
        dot_a = torch.sum(rho * (r_ck[:kdim] * inv_mass), -1)
        dot_b = torch.sum(rho * (r_new * inv_mass[None, :])[None], -1)
        in_range = (slots >= lo[None]) & (slots < pc[None])
        turn_sub = (((dot_a <= 0.0) | (dot_b <= 0.0)) & in_range).any(0) & ~even
        new_fail = live & (dvg | turn_sub)
        s_failed = s_failed | new_fail
        dvg_draw = dvg_draw | (live & dvg)

        upd = live & ~new_fail
        s_lw = torch.where(upd, s_lw_new, s_lw)
        s_cum = _sel(upd, s_cum_new, s_cum)
        mov = torch.where(col(upd), leaf, mov)

        # --- subtree end: merge into the global tree ----------------------
        merging = is_end & upd
        take = merging & (take_u < torch.exp(torch.clamp(s_lw - lw, max=0.0)))
        prop = torch.where(col(take), sp, prop)
        prop_val = torch.where(take, sp_val, prop_val)
        sides = torch.stack([merging & ~take_right, merging & take_right])
        ends = torch.where(sides[:, None, :, None], mov[None], ends)
        r_sum = _sel(merging, r_sum + s_cum, r_sum)
        lw = torch.where(merging, torch.logaddexp(lw, s_lw), lw)
        full_turn = _turning(r_sum, ends[0, 2], ends[1, 2], inv_mass)
        active = active & ~(is_end & s_failed) & ~new_fail & ~(merging & full_turn)

        # --- a finished chain writes its draw and restarts at n = 0 -------
        # (a stalled chain, n == 0, is in no tree: it neither advances nor
        # finishes)
        in_tree = working & (n > 0)
        n = torch.where(in_tree, n + 1, n)
        finished = in_tree & (~active | (n >= max_n))
        row = torch.where(finished, draw, s_len)
        zs[chains, row] = prop[0]
        aps[chains, row] = sum_acc / torch.clamp(cnt, min=1.0)
        dvgs[chains, row] = dvg_draw
        cnts[chains, row] = cnt
        draw = draw + finished.to(draw.dtype)
        flushed = flushed + (draw.min() > flushed).to(flushed.dtype)
        cur = torch.where(col(finished), prop, cur)
        val = torch.where(finished, prop_val, val)
        n = torch.where(finished, 0, n)
        active = active & ~finished
        it += 1
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

    def transition(z, val, grad, eps, inv_mass):
        return nuts_transition_batched(
            value_and_grad_fn, z, val, grad, eps, inv_mass, rng,
            max_depth=max_depth, max_delta_energy=max_delta_energy,
        )

    da = da_init(torch.tensor(init_step_size, dtype=dtype, device=dev))
    inv_mass = (torch.ones((d,), dtype=dtype, device=dev) if inv_mass0 is None
                else torch.as_tensor(inv_mass0, dtype=dtype, device=dev))
    s1 = torch.zeros((d,), dtype=dtype, device=dev)
    s2 = torch.zeros_like(s1)
    n_acc = 0
    warmup_leapfrog = 0
    syncs = 0
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
            tr.close(draws, t_end, iterations=iters)
        return VectorizedNUTSResult(
            samples=zs, accept_prob=aps, diverging=dvgs,
            num_leapfrog=torch.full((num_samples,), -(-iters // max(num_samples, 1)), dtype=torch.int64),
            step_size=eps_final, inv_mass=inv_mass, warmup_leapfrog=warmup_leapfrog,
            chain_leapfrog=c_leaps, host_syncs=syncs + pipe_syncs,
            sampling_seconds=(t_end - t_sampling) * 1e-9,
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
    )
