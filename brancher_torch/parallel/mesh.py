"""Process groups, device meshes and leading-axis sharding.

Counterpart of ``brancher_tpu/parallel/mesh.py`` (lines 1-84):
``initialize_distributed``, ``make_mesh``, ``chain_mesh``,
``particle_mesh``, ``batch_mesh`` and ``shard_leading_axis``.  The mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names``
are the config's axis names; a collective over a JAX axis name runs on
``mesh.get_group(axis_name)`` (``collectives.py``).

The SPMD convention (a deviation from the JAX package, which runs one
controller: ``sample(mesh=...)`` is called once there and ``shard_map``
returns the global result):

  * every rank of the process group calls the same entry point with the
    same arguments: key, ``num_chains`` (or particles, or samples), data
    and mesh;
  * each rank takes its equal block of the sharded axis, rows
    [r * C / n, (r + 1) * C / n) for its rank r along the mesh dimension,
    as ``P(axis)`` lays them out;
  * each rank runs its block on its own device (``cuda:LOCAL_RANK``, set
    by ``initialize_distributed``, or the CPU when asked);
  * each rank returns the GLOBAL result, gathered in rank order: the same
    shape as JAX's, and identical on every rank.

A randomness source the ranks must agree on (the resampling uniform of a
particle filter, PMMH's proposals in ``shard="particle"`` mode) stays
replicated; what each rank draws for its own block comes from
``collectives.fold_in(generator, rank)``, as JAX's ``fold_in(key,
axis_index)``.  So a sharded run differs from an unsharded one with the
same key, and from one over another number of ranks, as in JAX.

Building a mesh is collective: every rank of the world calls
``make_mesh`` with the same arguments, including the ranks a smaller mesh
leaves out (``DeviceMesh`` creates each dimension's group on every rank).
An entry point called on a rank outside its mesh raises ValueError.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import config, resolve_device
from .collectives import local_block, mesh_axis


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_seconds: float = 600.0,
) -> None:
    """Join this process to its process group: NCCL when ``device`` (default
    ``config.device``) is CUDA, after making ``cuda:LOCAL_RANK`` the current
    device, and gloo on the CPU.

    Without arguments it reads torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK).  ``coordinator_address`` is
    "host:port" (or a URL such as "tcp://host:port" or "file:///path").
    A no-op when a group already exists, or when the process runs alone:
    no argument and no RANK/WORLD_SIZE in the environment.  Any other
    failure raises (a run asked to span N processes must not run alone).
    A collective that waits longer than ``timeout_seconds`` fails.
    """
    if dist.is_initialized():
        return
    asked = coordinator_address is not None or num_processes is not None or process_id is not None
    if not asked and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return  # one process, no launcher: nothing to join
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" not in os.environ:
        raise ValueError("initialize_distributed needs process_id, or RANK in the environment")
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if resolve_device(device).type == "cuda":  # raises without CUDA
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_seconds))


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence[int]] = None, device=None):
    """A ``DeviceMesh`` from {axis_name: size} over ``devices``, global
    ranks (default: every rank of the group, in order).  A size of -1
    absorbs the remaining ranks; axis order is dict order, outermost
    first.  ``device``: the mesh's device type, default ``config.device``
    ("cuda"); "cpu" for a gloo group on the CPU.

    Needs a process group (``initialize_distributed``, or
    ``torch.distributed.init_process_group``); collective, see the module
    docstring."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: launch with torchrun "
            "and call initialize_distributed(), or call init_process_group first")
    devices = list(range(dist.get_world_size()) if devices is None else devices)
    sizes = dict(axes)
    known = int(np.prod([s for s in sizes.values() if s != -1]))
    for k, s in sizes.items():
        if s == -1:
            sizes[k] = len(devices) // known
    total = int(np.prod(list(sizes.values())))
    if total > len(devices):
        raise ValueError(f"mesh {sizes} needs {total} devices, have {len(devices)}")
    ranks = torch.tensor(devices[:total], dtype=torch.int64).reshape(tuple(sizes.values()))
    return DeviceMesh(resolve_device(device).type, ranks, mesh_dim_names=tuple(sizes))


def _axis_mesh(axis_name: str, num_devices: Optional[int], device):
    ranks = list(range(dist.get_world_size() if dist.is_initialized() else 1))
    ranks = ranks if num_devices is None else ranks[:num_devices]
    return make_mesh({axis_name: len(ranks)}, ranks, device)


def chain_mesh(num_devices: Optional[int] = None, device=None):
    """1-D mesh over the chain axis (MCMC chains), on the first
    ``num_devices`` ranks (default all)."""
    return _axis_mesh(config.chain_axis, num_devices, device)


def particle_mesh(num_devices: Optional[int] = None, device=None):
    """1-D mesh over the particle axis (SMC particles)."""
    return _axis_mesh(config.particle_axis, num_devices, device)


def batch_mesh(num_devices: Optional[int] = None, device=None):
    """1-D mesh over the Monte-Carlo batch axis (SVI)."""
    return _axis_mesh(config.batch_axis, num_devices, device)


def shard_leading_axis(x, mesh, axis_name: str):
    """This rank's block of the leading axis of a tensor, or of every
    tensor of a dict / tuple / list tree (the rest of each tensor whole):
    what JAX's ``NamedSharding(mesh, P(axis_name))`` places on it."""
    axis = mesh_axis(mesh, axis_name)

    def put(a):
        if isinstance(a, dict):
            return {k: put(v) for k, v in a.items()}
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return type(a)(*[put(v) for v in a])
        if isinstance(a, (tuple, list)):
            return type(a)(put(v) for v in a)
        return local_block(torch.as_tensor(a), axis)

    return put(x)
