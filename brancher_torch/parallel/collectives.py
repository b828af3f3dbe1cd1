"""Collectives over one dimension of a ``DeviceMesh``.

The port's counterparts of the axis-name primitives the JAX package calls
inside ``shard_map``: ``lax.psum``, ``pmax``, ``pmean``, ``all_gather``,
``axis_index`` and ``axis_size`` (``Axis``), and ``jax.random.fold_in``
for a ``torch.Generator`` (``fold_in``).  Each runs on the process group
of the mesh dimension (``DeviceMesh.get_group(name)``) and returns a new
tensor; none carries autograd.  Every rank of the group must make the same
calls in the same order, or the group waits until its timeout.

A rank's place along a dimension is its rank in that dimension's group:
``all_gather`` concatenates in that order and ``local_block`` takes that
block, so that a gathered result has the rows of ``P(axis)`` in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor


class Axis(NamedTuple):
    """One mesh dimension as this rank sees it: its process group, its
    size (JAX ``axis_size``) and this rank's place along it
    (``axis_index``)."""

    group: object
    size: int
    index: int


def mesh_axis(mesh, axis_name: str) -> Axis:
    """The ``Axis`` of ``mesh``'s dimension ``axis_name``.

    Raises TypeError when ``mesh`` is not a ``DeviceMesh``, and ValueError
    when it has no such dimension or this rank is not in it.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh (see "
            f"brancher_torch.parallel.make_mesh), got {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (its axes: {names})")
    if mesh.get_coordinate() is None:
        raise ValueError(
            f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}: "
            "call the entry point on the mesh's ranks only")
    group = mesh.get_group(axis_name)
    return Axis(group, dist.get_world_size(group), dist.get_rank(group))


def all_reduce(x: Tensor, op, group) -> Tensor:
    """``x`` reduced elementwise by ``op`` over ``group``, as a new tensor
    (0-d included)."""
    out = x.detach().clone().contiguous()
    dist.all_reduce(out.view(-1), op=op, group=group)
    return out


def psum(x: Tensor, axis: Axis) -> Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``lax.psum``)."""
    return all_reduce(x, dist.ReduceOp.SUM, axis.group)


def pmax(x: Tensor, axis: Axis) -> Tensor:
    """Elementwise maximum over the ranks of ``axis`` (``lax.pmax``)."""
    return all_reduce(x, dist.ReduceOp.MAX, axis.group)


def pmean(x: Tensor, axis: Axis) -> Tensor:
    """Mean over the ranks of ``axis`` (``lax.pmean``)."""
    return psum(x, axis) / axis.size


def all_gather(x: Tensor, axis: Axis) -> Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order: the
    global array of a leading-axis sharded one.  Booleans travel as
    uint8."""
    src = x.detach().contiguous()
    if src.dtype == torch.bool:
        return all_gather(src.to(torch.uint8), axis).to(torch.bool)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=0)


def local_block(x: Tensor, axis: Axis, what: str = "leading axis") -> Tensor:
    """This rank's equal block of the rows of ``x``: rows
    [index * n / size, (index + 1) * n / size).  Raises ValueError when
    they do not divide."""
    n = x.shape[0]
    if n % axis.size:
        raise ValueError(f"{what}={n} must divide over a mesh axis of size {axis.size}")
    rows = n // axis.size
    return x[axis.index * rows:(axis.index + 1) * rows]


def fold_in(generator: torch.Generator, index: Union[int, Sequence[int]]) -> torch.Generator:
    """A new generator on ``generator``'s device whose seed mixes one draw
    of ``generator`` with ``index`` (an int or ints), as
    ``jax.random.fold_in(key, index)`` derives a key.

    The draw advances ``generator`` by the same amount on every rank, so a
    replicated generator stays replicated; the new generators differ by
    ``index``.  One host read.
    """
    draw = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
    words = [int(draw)] + [int(i) for i in np.atleast_1d(index)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    out = torch.Generator(device=generator.device)
    out.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return out
