"""Symbolic graph core: variables, lazy links, probabilistic models.

Counterpart of ``brancher_tpu/variables.py``.  The DAG is data only:
operator overloading on variables builds ``PartialLink`` expressions and
nothing runs until ``brancher_torch.compiler`` walks the graph.

Constants (numbers, numpy arrays, tensors) are kept as CPU tensors in the
graph.  A walk reads them through ``ParamStore.const``, which returns the
copy on the compiled model's device; the compiled model caches that copy,
so data moves to the device once, not on every evaluation.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .config import default_dtype
from .distributions import Distribution

_var_counter = itertools.count()


def to_tensor(value: Any, dtype=None) -> torch.Tensor:
    """Coerce python scalars / numpy arrays / tensors to a tensor.

    Float inputs and bare python ints take the default float dtype;
    integer numpy arrays keep their dtype (as ``brancher_tpu.utilities
    .to_array`` does).  Tensors pass through unchanged.
    """
    if isinstance(value, torch.Tensor):
        return value if dtype is None else value.to(dtype)
    arr = np.asarray(value)
    if dtype is None:
        if arr.dtype.kind in "fc":
            dtype = default_dtype()
        elif arr.dtype.kind in "iu" and not isinstance(value, np.ndarray):
            dtype = default_dtype()
    t = torch.from_numpy(np.array(arr))
    return t if dtype is None else t.to(dtype)


class ParamStore:
    """Learnable leaves plus the device copies of the graph's constants.

    ``params`` maps names to tensors.  ``consts`` is the compiled model's
    cache of device copies, keyed by the identity of the CPU constant.
    """

    def __init__(
        self,
        params: Optional[Dict[str, Any]] = None,
        frozen: bool = True,
        device: Optional[torch.device] = None,
        consts: Optional[Dict[int, Tuple[torch.Tensor, torch.Tensor]]] = None,
    ):
        self.params: Dict[str, Any] = dict(params or {})
        self.frozen = frozen
        self.device = torch.device("cpu") if device is None else device
        self.consts = {} if consts is None else consts

    def get(self, name: str, init_fn: Optional[Callable] = None):
        if name in self.params:
            return self.params[name]
        if self.frozen or init_fn is None:
            raise KeyError(f"unknown parameter {name!r}")
        value = init_fn()
        self.params[name] = value
        return value

    def const(self, t: torch.Tensor) -> torch.Tensor:
        """The device copy of the graph constant ``t`` (made once)."""
        if t.device == self.device:
            return t
        hit = self.consts.get(id(t))
        if hit is None or hit[0] is not t:
            # the source tensor rides along so its id cannot be reused
            hit = (t, t.to(self.device))
            self.consts[id(t)] = hit
        return hit[1]


class PartialLink:
    """A lazy expression over variables: (vars, fn(values, params) -> Tensor)."""

    __array_priority__ = 100  # beat numpy's operators

    def __init__(self, variables: Sequence["Variable"],
                 fn: Callable[[Dict[str, torch.Tensor], ParamStore], torch.Tensor]):
        seen: Set[int] = set()
        ordered: List[Variable] = []
        for v in variables:
            if id(v) not in seen:
                seen.add(id(v))
                ordered.append(v)
        self.vars: Tuple[Variable, ...] = tuple(ordered)
        self.fn = fn

    @staticmethod
    def _binary(op, a, b) -> "PartialLink":
        la, lb = var2link(a), var2link(b)
        return PartialLink(
            tuple(la.vars) + tuple(lb.vars),
            lambda values, params: op(la.fn(values, params), lb.fn(values, params)),
        )

    def _unary(self, op) -> "PartialLink":
        return PartialLink(self.vars, lambda values, params: op(self.fn(values, params)))

    def __add__(self, other):
        return self._binary(torch.add, self, other)

    def __radd__(self, other):
        return self._binary(torch.add, other, self)

    def __sub__(self, other):
        return self._binary(torch.sub, self, other)

    def __rsub__(self, other):
        return self._binary(torch.sub, other, self)

    def __mul__(self, other):
        return self._binary(torch.mul, self, other)

    def __rmul__(self, other):
        return self._binary(torch.mul, other, self)

    def __truediv__(self, other):
        return self._binary(torch.true_divide, self, other)

    def __rtruediv__(self, other):
        return self._binary(torch.true_divide, other, self)

    def __pow__(self, other):
        return self._binary(torch.pow, self, other)

    def __rpow__(self, other):
        return self._binary(torch.pow, other, self)

    def __matmul__(self, other):
        return self._binary(torch.matmul, self, other)

    def __rmatmul__(self, other):
        return self._binary(torch.matmul, other, self)

    def __neg__(self):
        return self._unary(torch.neg)

    def __abs__(self):
        return self._unary(torch.abs)

    def __getitem__(self, item):
        return self._unary(lambda x: x[item])

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._unary(lambda x: torch.reshape(x, shape))

    def sum(self, axis=None):
        return self._unary(lambda x: torch.sum(x) if axis is None else torch.sum(x, dim=axis))

    @property
    def T(self):
        return self._unary(lambda x: torch.swapaxes(x, -1, -2))


_LINK_OPS = [
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__truediv__", "__rtruediv__", "__pow__", "__rpow__", "__matmul__",
    "__rmatmul__", "__neg__", "__abs__", "__getitem__",
]


def var2link(x: Any) -> PartialLink:
    """Coerce scalars / arrays / tensors / Variables / links into a PartialLink."""
    if isinstance(x, PartialLink):
        return x
    if isinstance(x, Variable):
        name = x.name
        return PartialLink((x,), lambda values, params, _n=name: values[_n])
    if isinstance(x, (list, tuple)) and any(isinstance(e, (Variable, PartialLink)) for e in x):
        links = [var2link(e) for e in x]
        all_vars = [v for l in links for v in l.vars]
        return PartialLink(
            all_vars,
            lambda values, params: torch.stack([l.fn(values, params) for l in links]),
        )
    const = to_tensor(x)
    return PartialLink((), lambda values, params: params.const(const))


class Variable:
    """Abstract symbolic node.  Operator overloading yields PartialLinks."""

    def __init__(self, name: Optional[str] = None):
        self._uid = next(_var_counter)
        self.name = name if name is not None else f"var_{self._uid}"
        self._observed = None
        self.version = 0  # bumped on observe/unobserve for cache invalidation

    def observe(self, data) -> None:
        """Condition this variable on data (fixes its value in log-joints)."""
        if isinstance(data, (Variable, PartialLink)):
            self._observed = var2link(data)
        else:
            self._observed = to_tensor(data)
        self.version += 1

    def unobserve(self) -> None:
        self._observed = None
        self.version += 1

    @property
    def is_observed(self) -> bool:
        return self._observed is not None

    @property
    def observed_value(self):
        return self._observed

    @property
    def parents(self) -> Tuple["Variable", ...]:
        return ()

    def __repr__(self):
        obs = ", observed" if self.is_observed else ""
        return f"<{type(self).__name__} {self.name!r}{obs}>"

    def __hash__(self):
        return self._uid

    def __eq__(self, other):
        return self is other


def _make_var_op(opname):
    def op(self, *args):
        return getattr(var2link(self), opname)(*args)

    op.__name__ = opname
    return op


for _opname in _LINK_OPS:
    setattr(Variable, _opname, _make_var_op(_opname))
Variable.reshape = lambda self, *s: var2link(self).reshape(*s)
Variable.sum = lambda self, axis=None: var2link(self).sum(axis=axis)
Variable.T = property(lambda self: var2link(self).T)


class RandomVariable(Variable):
    """A stochastic node: distribution + parameter links.

    Args:
      distribution: a ``Distribution`` kernel pair.
      name: unique variable name (the key in sample dicts).
      links: dict parameter-name -> anything coercible by ``var2link``.
      plate_shape: extra iid leading dims drawn beyond parameter broadcast.
      log_prob_scale: multiplier on this variable's log-prob contribution.
    """

    def __init__(
        self,
        distribution: Distribution,
        name: Optional[str] = None,
        links: Optional[Dict[str, Any]] = None,
        plate_shape: Tuple[int, ...] = (),
        log_prob_scale: float = 1.0,
    ):
        super().__init__(name)
        self.distribution = distribution
        self.links: Dict[str, PartialLink] = {
            k: var2link(v) for k, v in (links or {}).items() if v is not None
        }
        self.plate_shape = tuple(plate_shape)
        self.log_prob_scale = log_prob_scale

    @property
    def parents(self) -> Tuple[Variable, ...]:
        seen: Set[int] = set()
        out: List[Variable] = []
        for link in self.links.values():
            for v in link.vars:
                if id(v) not in seen:
                    seen.add(id(v))
                    out.append(v)
        return tuple(out)

    @property
    def is_discrete(self) -> bool:
        return self.distribution.is_discrete

    def eval_params(self, values: Dict[str, torch.Tensor], params: ParamStore):
        return {k: link.fn(values, params) for k, link in self.links.items()}


class DeterministicVariable(Variable):
    """A deterministic node: a constant, learnable leaf, or expression."""

    def __init__(self, value: Any = None, name: Optional[str] = None, learnable: bool = False):
        super().__init__(name)
        self.learnable = learnable
        if isinstance(value, (Variable, PartialLink)):
            if learnable:
                raise ValueError("expression-valued deterministic variables cannot be learnable")
            self.link: Optional[PartialLink] = var2link(value)
            self.value: Optional[torch.Tensor] = None
        else:
            self.link = None
            if value is None:
                raise ValueError("leaf DeterministicVariable needs a value")
            self.value = to_tensor(value)

    @property
    def parents(self) -> Tuple[Variable, ...]:
        return self.link.vars if self.link is not None else ()

    def compute(self, values: Dict[str, torch.Tensor], params: ParamStore) -> torch.Tensor:
        if self.link is not None:
            return self.link.fn(values, params)
        if self.learnable:
            return params.get(self.name, lambda: params.const(self.value).clone())
        return params.const(self.value)


def full_deps(v: Variable) -> Tuple[Variable, ...]:
    """Parents plus observation-link variables (data-loader pattern)."""
    deps = list(v.parents)
    obs = getattr(v, "_observed", None)
    if isinstance(obs, PartialLink):
        deps.extend(obs.vars)
    return tuple(deps)


def ancestral_closure(roots: Sequence[Variable]) -> List[Variable]:
    """Topologically ordered ancestral closure (parents before children),
    DFS post-order in declaration order as in the JAX package."""
    order: List[Variable] = []
    state: Dict[int, int] = {}  # 0 = visiting, 1 = done

    def visit(v: Variable):
        s = state.get(id(v))
        if s == 1:
            return
        if s == 0:
            raise ValueError(f"cycle detected through variable {v.name!r}")
        state[id(v)] = 0
        for p in full_deps(v):
            visit(p)
        state[id(v)] = 1
        order.append(v)

    for r in roots:
        visit(r)
    return order


class ProbabilisticModel:
    """Container for a DAG of variables; entry point for all inference."""

    def __init__(self, variables: Sequence[Variable]):
        if isinstance(variables, Variable):
            variables = [variables]
        self.output_variables: List[Variable] = list(variables)
        self.variables: List[Variable] = ancestral_closure(self.output_variables)
        names = [v.name for v in self.variables]
        dup = {n for n in names if names.count(n) > 1}
        if dup:
            raise ValueError(f"duplicate variable names in model: {sorted(dup)}")
        self.posterior_model: Optional[ProbabilisticModel] = None
        self.diagnostics: Dict[str, Any] = {}
        self._compiled_cache: Dict[Tuple, Any] = {}

    @property
    def random_variables(self) -> List[RandomVariable]:
        return [v for v in self.variables if isinstance(v, RandomVariable)]

    @property
    def latent_variables(self) -> List[RandomVariable]:
        return [v for v in self.random_variables if not v.is_observed]

    @property
    def observed_variables(self) -> List[RandomVariable]:
        return [v for v in self.random_variables if v.is_observed]

    def get_variable(self, name: str) -> Variable:
        for v in self.variables:
            if v.name == name:
                return v
        raise KeyError(name)

    def _refresh_structure(self) -> None:
        self.variables = ancestral_closure(self.output_variables)

    def _version_key(self) -> Tuple:
        return tuple((v.name, v.version) for v in self.variables)

    def compiled(self, device=None):
        """The model lowered for ``device`` (default ``config.device``),
        cached until an observation changes."""
        from .compiler import CompiledModel  # local import avoids a cycle
        from .config import resolve_device

        dev = resolve_device(device)  # "cuda" is "cuda:0" here, as in the CompiledModel
        self._refresh_structure()
        key = (self._version_key(), str(dev))
        if key not in self._compiled_cache:
            self._compiled_cache = {key: CompiledModel(self, device=dev)}
        return self._compiled_cache[key]

    def observe(self, data: Dict[Any, Any]) -> None:
        """Observe several variables at once: {variable-or-name: data}."""
        for k, v in data.items():
            var = k if isinstance(k, Variable) else self.get_variable(k)
            var.observe(v)
        self._refresh_structure()

    def unobserve_all(self) -> None:
        for v in self.variables:
            if v.is_observed:
                v.unobserve()

    # -- sampling ----------------------------------------------------------
    def get_sample_dict(self, number_samples: int, key=None,
                        input_values: Optional[Dict[str, Any]] = None,
                        params: Optional[Dict[str, Any]] = None, device=None) -> Dict[str, torch.Tensor]:
        """``number_samples`` ancestral draws {name: [n, ...]} on ``device``;
        key: an int seed or a ``torch.Generator`` there."""
        comp = self.compiled(device)
        return comp.sample(comp.initial_params if params is None else params, key,
                           number_samples, given=input_values)

    def get_sample(self, number_samples: int, key=None, input_values=None, params=None,
                   device=None):
        """``get_sample_dict`` as a tidy pandas DataFrame (reference API)."""
        from .pandas_interface import sample_dict_to_dataframe

        return sample_dict_to_dataframe(self.get_sample_dict(
            number_samples, key=key, input_values=input_values, params=params, device=device))

    def calculate_log_probability(self, samples, params: Optional[Dict[str, Any]] = None,
                                  for_gradient: bool = False, device=None) -> torch.Tensor:
        """Log-joint per sample, f32[n] on the model's device.  Accepts
        sample dicts, {Variable: array} mappings or DataFrames;
        ``for_gradient`` is accepted and unused, as in JAX."""
        from .pandas_interface import coerce_to_sample_dict

        del for_gradient
        comp = self.compiled(device)
        return comp.log_prob(comp.initial_params if params is None else params,
                             coerce_to_sample_dict(samples, device=comp.device))

    # -- posterior attachment ------------------------------------------------
    def set_posterior_model(self, model: "ProbabilisticModel") -> None:
        """Attach a variational model; correspondence is by variable NAME."""
        self.posterior_model = model

    def get_posterior_sample_dict(self, number_samples: int, key=None, params=None,
                                  device=None) -> Dict[str, torch.Tensor]:
        """Draws of the posterior model pushed through this model by name.
        ``params``: an SVI result's {"p": ..., "q": ...}; by default each
        model's compiled params (which SVI with a DSL guide updates)."""
        from .config import make_generator, resolve_device

        if self.posterior_model is None:
            raise ValueError("no posterior model set; call set_posterior_model first")
        dev = resolve_device(device)
        gen = make_generator(key, dev)
        params = params if isinstance(params, dict) else {}
        q_samples = self.posterior_model.get_sample_dict(
            number_samples, key=gen, params=params.get("q"), device=dev)
        p_names = {v.name for v in self.variables}
        given = {k: v for k, v in q_samples.items() if k in p_names}
        return self.get_sample_dict(number_samples, key=gen, input_values=given,
                                    params=params.get("p"), device=dev)

    def get_posterior_sample(self, number_samples: int, key=None, params=None, device=None):
        """``get_posterior_sample_dict`` as a pandas DataFrame."""
        from .pandas_interface import sample_dict_to_dataframe

        return sample_dict_to_dataframe(self.get_posterior_sample_dict(
            number_samples, key=key, params=params, device=device))

    def __repr__(self):
        return (
            f"<ProbabilisticModel vars={[v.name for v in self.variables]} "
            f"latents={[v.name for v in self.latent_variables]} "
            f"observed={[v.name for v in self.observed_variables]}>"
        )
