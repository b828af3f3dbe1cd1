"""Shape, sample-dict and tree helpers.

Counterpart of ``brancher_tpu/utilities.py`` (lines 24-82), under its
names.  A tree is what ``torch.utils._pytree`` flattens: dicts, lists,
tuples and named tuples, with tensors at the leaves; ``tree_flatten_concat``
orders dict keys sorted, as ``jax.flatten_util.ravel_pytree`` does.

``split_key_dict`` deviates: torch has no ``fold_in``, so it returns one
``torch.Generator`` per name, seeded from the caller's seed and the name's
index.  The mapping is deterministic, but it does not give JAX's numbers.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Mapping, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from .config import default_dtype, resolve_device
from .variables import to_tensor

Tensor = torch.Tensor
SampleDict = Dict[str, Tensor]


def to_array(value: Any, dtype=None) -> Tensor:
    """Coerce Python scalars, numpy arrays and tensors to a (CPU) tensor.

    Float inputs, and bare Python ints (almost always meant as floats, as
    in ``NormalVariable(0, 1)``), take the default float dtype; integer and
    bool numpy arrays keep theirs.  A tensor passes through unchanged."""
    return to_tensor(value, dtype)


def broadcast_shapes(*shapes: Sequence[int]) -> tuple:
    return tuple(torch.broadcast_shapes(*shapes))


def sum_all(x: Tensor) -> Tensor:
    """Sum every axis -> scalar (reduces a per-variable log-prob)."""
    return torch.sum(x)


def merge_sample_dicts(dicts: Iterable[Mapping[str, Tensor]]) -> SampleDict:
    out: SampleDict = {}
    for d in dicts:
        out.update(d)
    return out


def _sorted_leaves(tree: Any) -> Tuple[list, Any]:
    """Leaves and spec of ``tree`` with every dict's keys sorted first, the
    order ``jax.tree_util`` flattens in."""
    def canon(t):
        if isinstance(t, dict):
            return {k: canon(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(canon(e) for e in t))
        if isinstance(t, (list, tuple)):
            return type(t)(canon(e) for e in t)
        return t

    return pytree.tree_flatten(canon(tree))


def tree_stack(trees: Sequence[Any]) -> Any:
    """Stack a list of identical trees along a new leading axis."""
    return pytree.tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                           trees[0], *trees[1:])


def tree_index(tree: Any, idx) -> Any:
    return pytree.tree_map(lambda x: x[idx], tree)


def tree_flatten_concat(tree: Any) -> Tuple[Tensor, Callable[[Tensor], Any]]:
    """Flatten a tree of tensors into one 1-D vector and an unravel
    function, in ``jax.flatten_util.ravel_pytree``'s order (sorted dict
    keys, each leaf row-major); the vector takes the leaves' promoted
    dtype and unravel casts each leaf back to its own."""
    leaves, spec = _sorted_leaves(tree)
    leaves = [torch.as_tensor(x) for x in leaves]
    shapes = [tuple(x.shape) for x in leaves]
    dtypes = [x.dtype for x in leaves]
    sizes = [math.prod(s) for s in shapes]
    if leaves:
        dtype = leaves[0].dtype
        for x in leaves[1:]:
            dtype = torch.promote_types(dtype, x.dtype)
        flat = torch.cat([x.reshape(-1).to(dtype) for x in leaves])
    else:
        flat = torch.zeros((0,), dtype=default_dtype())

    def unravel(v: Tensor) -> Any:
        parts = torch.split(v, sizes) if sizes else []
        return pytree.tree_unflatten(
            [p.reshape(s).to(d) for p, s, d in zip(parts, shapes, dtypes)], spec)

    return flat, unravel


def split_key_dict(key, names: Sequence[str], device=None) -> Dict[str, torch.Generator]:
    """One generator per name, deterministically: the i-th is seeded with
    the i-th of ``len(names)`` 62-bit numbers drawn from ``key`` (a
    generator, which this advances, or an int seed of a CPU one), on
    ``key``'s device or ``device``.  JAX folds the index into the key
    (``jax.random.fold_in``); torch has none, so the streams differ from
    JAX's."""
    if isinstance(key, torch.Generator):
        src, dev = key, key.device
    else:
        src, dev = torch.Generator().manual_seed(int(key)), resolve_device(device)
    seeds = torch.randint(0, 2**62, (len(names),), generator=src, device=src.device).tolist()
    return {name: torch.Generator(device=dev).manual_seed(s) for name, s in zip(names, seeds)}
