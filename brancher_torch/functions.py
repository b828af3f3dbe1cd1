"""Lifted functions — the ``BF`` namespace.

Counterpart of ``brancher_tpu/functions.py``: ``_lift`` turns a tensor
function into a factory of ``PartialLink`` graph nodes, so that
``BF.exp(x) + BF.matmul(w, h)`` builds an expression over variables, and
``BrancherFunction`` (lines 42-75) lifts any tensor callable or
``torch.nn.Module``::

    net = BF.BrancherFunction(torch_module, name="decoder")
    logits = net(z)

A module's parameters register lazily in the compiled model's
``ParamStore`` under ``f"{name}__params"`` during the shape-probe pass (a
copy on the model's device, as flax params register in JAX), and the
module runs through ``torch.func.functional_call`` with the params the
walk is given, so the walks stay functional and the optimizer owns the
tensors.  The module's own tensors are only the initial values.

The lifted table mirrors lines 105-164, with the JAX package's argument
names (``axis=``, ``keepdims=``; ``jnp.clip`` is ``torch.clamp``), plus
``cat``/``concat`` and ``stack``.  ``einsum`` takes its subscripts first,
as ``jnp.einsum`` does.
"""
from __future__ import annotations

import builtins
import itertools
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from .distributions import softplus as _softplus
from .variables import PartialLink, ParamStore, Variable, var2link

_fn_counter = itertools.count()


def _is_symbolic(v) -> bool:
    return isinstance(v, (Variable, PartialLink))


def _links(args, kwargs):
    links = [var2link(a) for a in args]
    kw_links = {k: var2link(v) for k, v in kwargs.items()}
    all_vars = [v for l in links for v in l.vars] + [v for l in kw_links.values() for v in l.vars]
    return links, kw_links, all_vars


class BrancherFunction:
    """Lift a tensor callable or a ``torch.nn.Module`` into a graph function."""

    def __init__(self, fn: Any, name: Optional[str] = None):
        self.fn = fn
        self.is_module = isinstance(fn, torch.nn.Module)
        base = name or getattr(fn, "__name__", None) or type(fn).__name__
        self.name = f"{base}__fn{next(_fn_counter)}" if name is None else name

    def __call__(self, *args, **kwargs) -> PartialLink:
        links, kw_links, all_vars = _links(args, kwargs)
        raw = self.fn

        def inputs(values, params):
            return ([l.fn(values, params) for l in links],
                    {k: l.fn(values, params) for k, l in kw_links.items()})

        if not self.is_module:
            def fn(values, params: ParamStore):
                xs, kx = inputs(values, params)
                return raw(*xs, **kx)

            return PartialLink(all_vars, fn)

        pname = f"{self.name}__params"

        def init(params: ParamStore):
            return {k: p.detach().to(params.device).clone() for k, p in raw.named_parameters()}

        def module_fn(values, params: ParamStore):
            xs, kx = inputs(values, params)
            mp = params.get(pname, lambda: init(params))
            return torch.func.functional_call(raw, mp, tuple(xs), kx)

        return PartialLink(all_vars, module_fn)


def _lift(fn: Callable, name: str) -> Callable:
    def wrapper(*args, **kwargs):
        # keyword args that are plain python config (axis=...) pass through
        links = [var2link(a) for a in args]
        all_vars = [v for l in links for v in l.vars]
        sym_kw = {k: var2link(v) for k, v in kwargs.items() if _is_symbolic(v)}
        static_kw = {k: v for k, v in kwargs.items() if not _is_symbolic(v)}
        all_vars += [v for l in sym_kw.values() for v in l.vars]

        def link_fn(values, params):
            xs = [l.fn(values, params) for l in links]
            kx = {k: l.fn(values, params) for k, l in sym_kw.items()}
            return fn(*xs, **kx, **static_kw)

        return PartialLink(all_vars, link_fn)

    wrapper.__name__ = name
    return wrapper


# -- jnp semantics on torch tensors ------------------------------------------
def _reduce(op):
    """A jnp reduction (``axis=None`` reduces everything) from a torch one."""
    def f(x, axis=None, keepdims=False):
        if axis is None:
            out = op(x)
            return out.reshape((1,) * x.dim()) if keepdims else out
        return op(x, dim=axis, keepdim=keepdims)
    return f


def _dot(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [builtins.max(b.dim() - 2, 0)]))


def _transpose(x, axes=None):
    return x.permute(*(reversed(range(x.dim())) if axes is None else axes))


def _squeeze(x, axis=None):
    return torch.squeeze(x) if axis is None else torch.squeeze(x, dim=axis)


def _take(a, indices, axis=None):
    indices = indices.long()
    if axis is None:
        # indexing the flattened array, not torch.take: take has no batching
        # rule under torch.func.vmap (an enumerated index is batched)
        return a.reshape(-1)[indices]
    axis = axis % a.dim()
    out = torch.index_select(a, axis, indices.reshape(-1))
    return out.reshape(a.shape[:axis] + indices.shape + a.shape[axis + 1:])


def _cumsum(x, axis=None):
    return torch.cumsum(x.reshape(-1), 0) if axis is None else torch.cumsum(x, dim=axis)


# -- lifted math namespace (mirrors the reference's BF.*) -------------------
exp = _lift(torch.exp, "exp")
log = _lift(torch.log, "log")
log1p = _lift(torch.log1p, "log1p")
sqrt = _lift(torch.sqrt, "sqrt")
abs = _lift(torch.abs, "abs")
sin = _lift(torch.sin, "sin")
cos = _lift(torch.cos, "cos")
tan = _lift(torch.tan, "tan")
tanh = _lift(torch.tanh, "tanh")
sinh = _lift(torch.sinh, "sinh")
cosh = _lift(torch.cosh, "cosh")
erf = _lift(torch.special.erf, "erf")
sigmoid = _lift(torch.sigmoid, "sigmoid")
softplus = _lift(_softplus, "softplus")  # no threshold, as jax.nn.softplus
softmax = _lift(lambda x, axis=-1: torch.softmax(x, dim=axis), "softmax")
log_softmax = _lift(lambda x, axis=-1: torch.log_softmax(x, dim=axis), "log_softmax")
relu = _lift(torch.relu, "relu")
gelu = _lift(lambda x, approximate=True: F.gelu(x, approximate="tanh" if approximate else "none"),
             "gelu")
matmul = _lift(torch.matmul, "matmul")
dot = _lift(_dot, "dot")
sum = _lift(_reduce(torch.sum), "sum")
prod = _lift(_reduce(torch.prod), "prod")
mean = _lift(_reduce(torch.mean), "mean")
max = _lift(_reduce(torch.amax), "max")
min = _lift(_reduce(torch.amin), "min")
reshape = _lift(torch.reshape, "reshape")
transpose = _lift(_transpose, "transpose")
squeeze = _lift(_squeeze, "squeeze")
expand_dims = _lift(lambda x, axis: torch.unsqueeze(x, axis), "expand_dims")
clip = _lift(lambda x, min=None, max=None: torch.clamp(x, min, max), "clip")
where = _lift(torch.where, "where")
power = _lift(torch.pow, "power")
maximum = _lift(torch.maximum, "maximum")
minimum = _lift(torch.minimum, "minimum")
take = _lift(_take, "take")
one_hot = _lift(lambda x, num_classes: F.one_hot(x.long(), num_classes).float(), "one_hot")
cumsum = _lift(_cumsum, "cumsum")


def einsum(subscripts: str, *operands):
    """``jnp.einsum(subscripts, *operands)`` over symbolic operands."""
    return _lift(lambda *xs: torch.einsum(subscripts, *xs), "einsum")(*operands)


def cat(links, axis=0):
    """Concatenate symbolic tensors (reference's BF.cat)."""
    links = [var2link(l) for l in links]
    all_vars = [v for l in links for v in l.vars]
    return PartialLink(
        all_vars, lambda values, params: torch.cat([l.fn(values, params) for l in links], dim=axis))


concat = cat


def stack(links, axis=0):
    links = [var2link(l) for l in links]
    all_vars = [v for l in links for v in l.vars]
    return PartialLink(
        all_vars, lambda values, params: torch.stack([l.fn(values, params) for l in links], dim=axis))
