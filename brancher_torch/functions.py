"""Lifted functions — the ``BF`` namespace.

Counterpart of ``brancher_tpu/functions.py``: ``_lift`` turns a tensor
function into a factory of ``PartialLink`` graph nodes, so that
``BF.exp(x) + BF.matmul(w, h)`` builds an expression over variables.

Ported so far: ``_lift`` and the lifted ``exp`` and ``matmul`` of the
main path.  ``BrancherFunction`` (modules as graph functions) and the
rest of the namespace are still to port (ROADMAP queue 1, items 10 and
14).
"""
from __future__ import annotations

from typing import Callable

import torch

from .variables import PartialLink, Variable, var2link


def _is_symbolic(v) -> bool:
    return isinstance(v, (Variable, PartialLink))


def _lift(fn: Callable, name: str) -> Callable:
    def wrapper(*args, **kwargs):
        # keyword args that are plain python config (dim=...) pass through
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


exp = _lift(torch.exp, "exp")
matmul = _lift(torch.matmul, "matmul")
