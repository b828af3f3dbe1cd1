"""Vectorized (chain-batched) NUTS: all chains advance in lockstep.

Counterpart of ``brancher_tpu/inference/vectorized_nuts.py``:
``nuts_transition_batched`` (lines 100-311) and ``nuts_batched``
(lines 729-839), lockstep only.  The draw-pipelined engine
(``_pipelined_sampling``) is still to port (ROADMAP queue 1, item 12).

The tree's doubling schedule is deterministic and shared by every chain:
leaf n belongs to doubling floor(log2 n) at in-subtree position
m = n - 2^depth.  In the JAX package that schedule is computed on the
device inside a ``while_loop``; here the loop runs on the host, so n,
depth, m, the checkpoint slot popcount(m) and the U-turn slot range are
Python ints and the schedule's branches are Python ``if``s.  Only the
per-chain direction, proposal swaps and stopping are tensors.  The loop
condition ``any(active)`` costs one host sync per leaf.

Randomness is injectable: a transition reads its momenta and, per leaf,
its direction, swap and take draws from a source object with the
methods of ``TorchNutsRandom``, so a test can replay JAX's stream
(``k_mom`` normals; per leaf ``fold_in(k_loop, n)`` split in three) and
hold one transition to the JAX one.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .adaptation import build_warmup_schedule, da_init, da_restart, da_update

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
    num_leapfrog: Tensor  # [S] loop iterations per draw
    step_size: Tensor
    inv_mass: Tensor
    warmup_leapfrog: int  # loop iterations during warmup
    chain_leapfrog: Tensor  # [S] mean per-chain live leapfrogs per draw
    host_syncs: int  # device->host syncs of the whole run


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
        if not bool(active.any()):
            break
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
        n += 1

    accept_prob = sum_acc / torch.clamp(cnt, min=1.0)
    return Transition(prop_z, prop_val, prop_grad, accept_prob, diverging,
                      n - 1, torch.mean(cnt), syncs)


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
) -> VectorizedNUTSResult:
    """Full vectorized-NUTS run with shared warmup adaptation: dual-averaged
    step size on the mean accept probability over chains, and a diagonal
    mass from cross-chain moments at each window end."""
    c, d = z0.shape
    dtype, dev = z0.dtype, z0.device
    rng = TorchNutsRandom(generator) if rng is None else rng
    z, (val, grad) = z0, value_and_grad_fn(z0)
    in_slow, window_end = build_warmup_schedule(num_warmup)

    def transition(z, val, grad, eps, inv_mass):
        return nuts_transition_batched(
            value_and_grad_fn, z, val, grad, eps, inv_mass, rng,
            max_depth=max_depth, max_delta_energy=max_delta_energy,
        )

    da = da_init(torch.tensor(init_step_size, dtype=dtype, device=dev))
    inv_mass = torch.ones((d,), dtype=dtype, device=dev)
    s1 = torch.zeros((d,), dtype=dtype, device=dev)
    s2 = torch.zeros_like(s1)
    n_acc = 0
    warmup_leapfrog = 0
    syncs = 0
    for i in range(num_warmup):
        t = transition(z, val, grad, torch.exp(da.log_step), inv_mass)
        z, val, grad = t.z, t.val, t.grad
        warmup_leapfrog += t.num_leaves
        syncs += t.host_syncs
        da = da_update(da, torch.mean(t.accept_prob), target_accept=target_accept)
        if in_slow[i]:
            s1 = s1 + torch.sum(z, dim=0)
            s2 = s2 + torch.sum(z * z, dim=0)
            n_acc += c
        if window_end[i]:
            ng = float(n_acc)
            mean = s1 / max(ng, 1.0)
            var = s2 / max(ng, 1.0) - mean * mean
            inv_mass = (ng / (ng + 5.0)) * var + 1e-3 * (5.0 / (ng + 5.0))
            s1, s2, n_acc = torch.zeros_like(s1), torch.zeros_like(s2), 0
            da = da_restart(da)
    eps_final = (torch.exp(da.log_step_avg) if num_warmup > 0
                 else torch.tensor(init_step_size, dtype=dtype, device=dev))

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
    return VectorizedNUTSResult(
        samples=zs.transpose(0, 1),
        accept_prob=aps.transpose(0, 1),
        diverging=dvgs.transpose(0, 1),
        num_leapfrog=torch.tensor(n_leaps, dtype=torch.int64),
        step_size=eps_final,
        inv_mass=inv_mass,
        warmup_leapfrog=warmup_leapfrog,
        chain_leapfrog=c_leaps,
        host_syncs=syncs,
    )
