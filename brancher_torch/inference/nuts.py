"""No-U-Turn Sampler: the kernel's settings and its per-chain step.

Counterpart of ``brancher_tpu/inference/nuts.py``: the ``NUTS`` settings
that ``sample()`` reads (``max_depth``, ``target_accept``,
``max_delta_energy``, and ``pipelined`` / ``lookahead`` for the
vectorized engine's draw-pipelined sampling), ``NUTS.make_step`` (lines
102-307) and ``nuts_sample``.

``make_step`` is the per-chain engine of ``sample(chain_method="vmap")``:
multinomial NUTS with the iterative tree of JAX's module (an outer loop
over doublings, an inner loop adding one leaf at a time, a checkpoint
stack of ``max_depth + 1`` momenta addressed by the popcount of the leaf
index, the generalized U-turn criterion).  JAX writes it for one chain
and ``vmap``s it, which runs every chain's ``while_loop`` as a masked
batch; ``torch.func.vmap`` refuses data-dependent loops and random draws,
so the port's step is that masked batch over a [C, d] block: every chain
builds its own tree, and a chain whose tree (or subtree) has stopped
keeps its state while the others go on.  Doublings and leaves advance
together because a subtree's size depends only on its depth; the loops
end when no chain runs (one host sync a leaf).  Its draws come from a
source with the methods of ``hmc.TorchChainRandom``, indexed by
(depth, leaf), so a test can feed JAX's per-chain numbers.  As in JAX the
step launches no kernel: its value and gradient are the vmapped autodiff
of the potential.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .hmc import VG, ChainState, autodiff_value_and_grad, kinetic_energy, leapfrog
from .vectorized_nuts import _sel, _turning

Tensor = torch.Tensor


class _Leaf(NamedTuple):
    z: Tensor  # [C, d]
    r: Tensor  # [C, d]
    pe: Tensor  # [C]
    grad: Tensor  # [C, d], d pe / dz


def _pick(mask: Tensor, a: _Leaf, b: _Leaf) -> _Leaf:
    """Leaf-wise where(mask, a, b) with a [C] mask."""
    return _Leaf(*(_sel(mask, x, y) for x, y in zip(a, b)))


class NUTS:
    """NUTS kernel config (plugs into mcmc.sample).

    pipelined (vectorized chain_method only): each chain starts its next
    draw in the iteration after its U-turn instead of idling until the
    slowest chain's tree completes (``vectorized_nuts._pipelined_sampling``);
    warmup stays lockstep.  lookahead: a chain may run at most this many
    draws ahead of the slowest before it idles.
    """

    def __init__(self, max_depth: int = 10, target_accept: float = 0.8,
                 max_delta_energy: float = 1000.0, pipelined: bool = False,
                 lookahead: int = 16):
        self.max_depth = max_depth
        self.target_accept = target_accept
        self.max_delta_energy = max_delta_energy
        self.pipelined = pipelined
        self.lookahead = lookahead

    def make_step(self, potential_fn: Callable, value_and_grad_fn: Optional[VG] = None):
        """The per-chain transition ``step(rng, state, step_size, inv_mass)
        -> (state, stats)`` over a [C, d] block.  ``value_and_grad_fn``
        ([C, d] -> log density, gradient) defaults to the vmapped autodiff
        of ``potential_fn``; ``rng`` has ``TorchChainRandom``'s methods."""
        vg = value_and_grad_fn or autodiff_value_and_grad(potential_fn)
        max_depth, max_delta = self.max_depth, self.max_delta_energy

        def step(rng, state: ChainState, step_size: Tensor, inv_mass: Tensor):
            z = state.z
            c, d = z.shape
            like = state.pe
            r0 = rng.momentum(z) / torch.sqrt(inv_mass)
            h0 = state.pe + kinetic_energy(r0, inv_mass)
            leaf0 = _Leaf(z, r0, state.pe, state.grad)
            left = right = prop = leaf0
            r_sum = r0
            log_weight = torch.zeros_like(like)
            depth = torch.zeros((c,), dtype=torch.int32, device=z.device)
            turning = torch.zeros((c,), dtype=torch.bool, device=z.device)
            diverging = torch.zeros_like(turning)
            sum_accept = torch.zeros_like(like)
            count = torch.zeros_like(like)
            # momenta and their running sums at the subtree's even leaves;
            # a stopped chain's slots are never read again, so writes are
            # not masked
            r_ck = torch.zeros((max_depth + 1, c, d), dtype=z.dtype, device=z.device)
            rs_ck = torch.zeros_like(r_ck)
            syncs = 0

            for dep in range(max_depth):
                running = ~(turning | diverging)
                syncs += 1
                if not bool(running.any()):
                    break
                go_right, merge_u = rng.tree(dep, c, like)
                step_signed = torch.where(go_right, step_size, -step_size)
                # the subtree grown from the chosen end: 2**dep leaves
                end = start = _pick(go_right, right, left)
                s_prop = start
                cum_rsum = torch.zeros_like(z)
                s_lw = torch.full_like(like, -torch.inf)
                s_turn = torch.zeros_like(turning)
                s_div = torch.zeros_like(turning)
                s_acc = torch.zeros_like(like)
                s_cnt = torch.zeros_like(like)
                for n in range(2**dep):
                    live = running & ~(s_turn | s_div)
                    if n > 0:
                        syncs += 1
                        if not bool(live.any()):
                            break
                    z1, r1, pe1, grad1 = leapfrog(vg, end.z, end.r, end.grad, step_signed, inv_mass, 1)
                    leaf = _Leaf(z1, r1, pe1, grad1)
                    h = leaf.pe + kinetic_energy(leaf.r, inv_mass)
                    h = torch.where(torch.isnan(h), torch.inf, h)
                    div = h - h0 > max_delta
                    s_acc = torch.where(live, s_acc + torch.exp(torch.clamp(h0 - h, max=0.0)), s_acc)
                    s_cnt = torch.where(live, s_cnt + 1.0, s_cnt)
                    pc = bin(n).count("1")
                    even = n % 2 == 0
                    if even:  # checkpoint slot popcount(n), before adding this leaf
                        r_ck[pc] = leaf.r
                        rs_ck[pc] = cum_rsum
                    new_cum = cum_rsum + leaf.r
                    turn = torch.zeros_like(turning)
                    if not even:  # against the completed subtrees ending here
                        lo = pc - bin((n ^ (n + 1)) >> 1).count("1")
                        for k in range(lo, pc):
                            turn = turn | _turning(new_cum - rs_ck[k], r_ck[k], leaf.r, inv_mass)
                    lw_leaf = h0 - h
                    new_lw = torch.logaddexp(s_lw, lw_leaf)
                    swap = rng.leaf(dep, n, c, like) < torch.exp(lw_leaf - new_lw)
                    bad = div | turn
                    # on a bad leaf the subtree is discarded: freeze its
                    # proposal and weights, keep the accept statistics
                    keep = live & ~bad
                    s_prop = _pick(keep & swap, leaf, s_prop)
                    s_lw = torch.where(keep, new_lw, s_lw)
                    cum_rsum = _sel(keep, new_cum, cum_rsum)
                    end = _pick(live, leaf, end)
                    s_turn = torch.where(live, turn, s_turn)
                    s_div = torch.where(live, div, s_div)

                # merge the subtree into the tree (biased progressive)
                sum_accept = torch.where(running, sum_accept + s_acc, sum_accept)
                count = torch.where(running, count + s_cnt, count)
                bad_sub = s_turn | s_div
                take = running & ~bad_sub & (merge_u < torch.exp(torch.clamp(s_lw - log_weight, max=0.0)))
                prop = _pick(take, s_prop, prop)
                grow = running & ~bad_sub
                right = _pick(grow & go_right, end, right)
                left = _pick(grow & ~go_right, end, left)
                r_sum = _sel(grow, r_sum + cum_rsum, r_sum)
                log_weight = torch.where(grow, torch.logaddexp(log_weight, s_lw), log_weight)
                full_turn = _turning(r_sum, left.r, right.r, inv_mass)
                turning = torch.where(running, s_turn | full_turn, turning)
                diverging = torch.where(running, s_div, diverging)
                depth = depth + running.to(depth.dtype)

            stats = {
                "accept_prob": sum_accept / torch.clamp(count, min=1.0),
                "diverging": diverging,
                "energy": prop.pe + kinetic_energy(prop.r, inv_mass),
                "num_steps": count.to(torch.int32),
                "tree_depth": depth,
                "host_syncs": syncs,
            }
            return ChainState(prop.z, prop.pe, prop.grad), stats

        return step


def nuts_sample(model, **kwargs):
    """Convenience: run NUTS on a ProbabilisticModel (see mcmc.sample)."""
    from .mcmc import sample

    kernel = NUTS(**{k: kwargs.pop(k) for k in list(kwargs)
                     if k in ("max_depth", "target_accept", "max_delta_energy")})
    return sample(model, kernel=kernel, **kwargs)
