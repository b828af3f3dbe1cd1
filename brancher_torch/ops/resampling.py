"""Collectives of the sharded particle filters.

Counterpart of ``brancher_tpu/ops/resampling.py`` (lines 30-74):

  * ``distributed_logsumexp`` / ``distributed_ess``: the log-sum-exp and
    the effective sample size of a vector sharded over a group, by a MAX
    and a SUM all-reduce (no gather);
  * ``ring_exchange``: rows of a sharded array fetched by GLOBAL index,
    through n - 1 rounds in which every rank sends its buffer to the next
    rank and receives the previous one's (``batch_isend_irecv``, JAX's
    ``ppermute`` ring).  At round r the buffer holds the block of rank
    (my - r) mod n, and every slot whose source lives there takes it; a
    rank holds one extra block at a time, where an all-gather would hold
    n.

``group`` is a process group: ``mesh.get_group(axis_name)`` of a
``DeviceMesh``.  There is no kernel here in either package: JAX's
collectives are XLA's, these are NCCL's (or gloo's on the CPU).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import all_reduce as _all_reduce

Tensor = torch.Tensor


def distributed_logsumexp(v_local: Tensor, group) -> Tensor:
    """logsumexp of a sharded vector: the MAX over ranks, then the SUM of
    exp(v - max)."""
    m = _all_reduce(torch.max(v_local), dist.ReduceOp.MAX, group)
    s = _all_reduce(torch.sum(torch.exp(v_local - m)), dist.ReduceOp.SUM, group)
    return m + torch.log(s)


def distributed_ess(lw_local: Tensor, group) -> Tensor:
    """Effective sample size of sharded log-weights."""
    w = torch.exp(lw_local - distributed_logsumexp(lw_local, group))
    return 1.0 / _all_reduce(torch.sum(w * w), dist.ReduceOp.SUM, group)


def ring_exchange(x_local: Tensor, src_global: Tensor, group) -> Tensor:
    """Rows of the sharded array x by global index, over the ring.

    x_local: [local_p, ...], this rank's block of x.  src_global: [local_p]
    integers, for each output slot the global row to fetch.  Returns
    x[src_global] [local_p, ...].
    """
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    local_p = x_local.shape[0]
    src_shard = src_global // local_p
    src_off = src_global % local_p
    nxt = dist.get_global_rank(group, (my + 1) % n)
    prv = dist.get_global_rank(group, (my - 1) % n)
    extra = (1,) * (x_local.dim() - 1)
    out = torch.zeros_like(x_local)
    buf = x_local.contiguous()
    for r in range(n):
        owner = (my - r) % n
        take = (src_shard == owner).reshape((local_p,) + extra)
        out = torch.where(take, buf[src_off], out)
        if r < n - 1:
            incoming = torch.empty_like(buf)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, nxt, group),
                                           dist.P2POp(dist.irecv, incoming, prv, group)])
            for req in reqs:
                req.wait()
            buf = incoming
    return out
