"""DAG -> tensor-function compiler: the core without enumeration.

Counterpart of ``brancher_tpu/compiler.py``.  ``CompiledModel`` walks the
frozen DAG in topological order and evaluates, for ONE sample:

  * ``sample_one(params, generator, given)`` — ancestral sampling
  * ``log_density_z(params, z, given)``      — log-joint + Jacobians in
                                               unconstrained space (the
                                               target NUTS differentiates)
  * ``log_density_z_parts`` / ``log_prior_z`` / ``eval_observed_params``
    — the split, the prior half alone, and the observed-likelihood
    parameters that the GLM recognizer probes
  * ``constrain`` / ``unconstrain``          — support bijections

There is no trace step: the walks run eagerly, and a chain axis is added
with ``torch.func.vmap`` by the caller.  The walks therefore avoid
``.item()``, in-place ops and Python branches on tensor values.

Flat latents follow ``jax.flatten_util.ravel_pytree`` of the JAX
package: the continuous latents in SORTED name order, each flattened
row-major (``ravel_z`` / ``unravel_z``).

The discrete-enumeration stack of the JAX compiler (compiler.py:528-1848)
is still to port (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .config import make_generator, resolve_device
from .transforms import transform_for
from .variables import (
    DeterministicVariable,
    ParamStore,
    PartialLink,
    ProbabilisticModel,
    RandomVariable,
    Variable,
    ancestral_closure,
)

Tensor = torch.Tensor


class CompiledModel:
    """Frozen lowering of a ProbabilisticModel onto one device (default
    ``config.device``, as for every entry point)."""

    def __init__(self, model: ProbabilisticModel, device=None):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.model = model
        self.order: List[Variable] = ancestral_closure(model.output_variables)
        self.names: List[str] = [v.name for v in self.order]
        self.latent_names: List[str] = [
            v.name for v in self.order
            if isinstance(v, RandomVariable) and not v.is_observed
        ]
        self.continuous_latent_names: List[str] = [
            v.name for v in self.order
            if isinstance(v, RandomVariable) and not v.is_observed
            and not v.distribution.is_discrete
        ]
        self.discrete_latent_names: List[str] = [
            n for n in self.latent_names if n not in self.continuous_latent_names
        ]
        self.observed_names: List[str] = [
            v.name for v in self.order if isinstance(v, RandomVariable) and v.is_observed
        ]
        # device copies of the graph's constants, filled on first read
        self._consts: Dict[int, Tuple[Tensor, Tensor]] = {}

        # ---- shape-probe pass: initializes lazy params, records shapes ----
        store = ParamStore({}, frozen=False, device=dev, consts=self._consts)
        probe_vals = self._walk_sample(store, make_generator(0, dev), {})
        self.initial_params: Dict[str, Any] = store.params
        self.shapes: Dict[str, Tuple[int, ...]] = {
            k: tuple(v.shape) for k, v in probe_vals.items()
        }
        self.z_shapes: Dict[str, Tuple[int, ...]] = {}
        for v in self.order:
            if v.name in self.continuous_latent_names:
                tr = transform_for(v.distribution, v.eval_params(probe_vals, store))
                self.z_shapes[v.name] = tuple(tr.unconstrained_shape(self.shapes[v.name]))
        # flat layout: sorted names, as ravel_pytree orders a dict
        self._layout: List[Tuple[str, Tuple[int, ...], int, int]] = []
        off = 0
        for name in sorted(self.z_shapes):
            size = math.prod(self.z_shapes[name])
            self._layout.append((name, self.z_shapes[name], off, size))
            off += size
        self.dim = off

    # ------------------------------------------------------------------
    def _as_store(self, params) -> ParamStore:
        if isinstance(params, ParamStore):
            return params
        return ParamStore(params, frozen=True, device=self.device, consts=self._consts)

    def _expand_plate(self, v: RandomVariable, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
        if not v.plate_shape:
            return params
        if v.distribution.event_ndim != 0:
            raise NotImplementedError(
                "plates over event-valued distributions come with those "
                "distributions (ROADMAP queue 1, item 14)"
            )
        shape = torch.broadcast_shapes(*(p.shape for p in params.values())) if params else ()
        target = tuple(v.plate_shape) + tuple(shape)
        return {k: torch.broadcast_to(p, target) for k, p in params.items()}

    def _rv_log_prob(self, v: RandomVariable, value, dist_params) -> Tensor:
        lp = torch.sum(v.distribution.log_prob(value, **dist_params))
        if v.log_prob_scale != 1.0:
            lp = v.log_prob_scale * lp
        return lp

    def _observed_value(self, v: Variable, values, store: ParamStore):
        obs = v._observed
        if isinstance(obs, PartialLink):
            return obs.fn(values, store)
        return store.const(obs)

    def _params(self, v: RandomVariable, values, store):
        return self._expand_plate(v, v.eval_params(values, store))

    # ------------------------------------------------------------------
    # The single-sample graph walks.
    # ------------------------------------------------------------------
    def _walk_sample(self, store: ParamStore, generator: torch.Generator,
                     given: Dict[str, Tensor]) -> Dict[str, Tensor]:
        values: Dict[str, Tensor] = {}
        for v in self.order:
            if v.name in given:
                values[v.name] = store.const(torch.as_tensor(given[v.name]))
                continue
            if isinstance(v, DeterministicVariable):
                values[v.name] = v.compute(values, store)
                continue
            values[v.name] = v.distribution.sample(generator, **self._params(v, values, store))
        return values

    def _latent_value(self, v: RandomVariable, p, z: Dict[str, Tensor]):
        if v.distribution.is_discrete:
            raise ValueError(
                f"discrete latent {v.name!r} must be provided via `given` "
                "for unconstrained-space log density"
            )
        tr = transform_for(v.distribution, p)
        zv = z[v.name]
        return tr.forward(zv), torch.sum(tr.forward_log_det(zv))

    def _walk_z(self, store: ParamStore, z: Dict[str, Tensor], given: Dict[str, Tensor],
                with_log_prob: bool = True, with_likelihood: bool = True):
        """z -> (values, prior part, likelihood part).

        The prior part holds the latents' log-probs and Jacobians and the
        log-probs of ``given`` variables; the likelihood part the observed
        variables'.  ``with_log_prob=False`` computes the values alone (for
        ``constrain``, which must not evaluate a large likelihood);
        ``with_likelihood=False`` leaves the likelihood part at 0 without
        evaluating the observed variables' parameters or log-probs (for
        ``log_prior_z``)."""
        values: Dict[str, Tensor] = {}
        lp_prior = lp_lik = torch.zeros((), device=self.device)
        for v in self.order:
            if isinstance(v, DeterministicVariable):
                values[v.name] = v.compute(values, store)
                continue
            if v.is_observed and v.name not in given:
                values[v.name] = self._observed_value(v, values, store)
                if with_log_prob and with_likelihood:
                    p = self._params(v, values, store)
                    lp_lik = lp_lik + self._rv_log_prob(v, values[v.name], p)
                continue
            p = self._params(v, values, store) if (with_log_prob or v.name in z) else None
            if v.name in given:
                value = store.const(torch.as_tensor(given[v.name]))
                values[v.name] = value
                if with_log_prob:
                    lp_prior = lp_prior + self._rv_log_prob(v, value, p)
                continue
            x, ld = self._latent_value(v, p, z)
            values[v.name] = x
            if with_log_prob:
                lp_prior = lp_prior + self._rv_log_prob(v, x, p) + ld
        return values, lp_prior, lp_lik

    # ------------------------------------------------------------------
    # Public per-sample API
    # ------------------------------------------------------------------
    def sample_one(self, params, generator=None, given: Optional[Dict[str, Tensor]] = None):
        """One ancestral draw: {name: value} for every variable, with
        ``given`` entries clamped."""
        gen = make_generator(generator, self.device)
        return self._walk_sample(self._as_store(params), gen, given or {})

    def log_density_z(self, params, z: Dict[str, Tensor],
                      given: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """Joint log-density at UNCONSTRAINED latents ``z`` including the
        support-transform Jacobians — the target MCMC differentiates."""
        _, lp_prior, lp_lik = self._walk_z(self._as_store(params), z, given or {})
        return lp_prior + lp_lik

    def log_density_z_parts(self, params, z: Dict[str, Tensor],
                            given: Optional[Dict[str, Tensor]] = None) -> Tuple[Tensor, Tensor]:
        """(log prior incl. Jacobian, log likelihood) in unconstrained space."""
        _, lp_prior, lp_lik = self._walk_z(self._as_store(params), z, given or {})
        return lp_prior, lp_lik

    def log_prior_z(self, params, z: Dict[str, Tensor],
                    given: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """``log_density_z_parts(...)[0]`` without evaluating the
        likelihood: the observed variables' log-probs never run (the GLM
        recognizer's prior probe; its cost does not grow with the data)."""
        return self._walk_z(self._as_store(params), z, given or {}, with_likelihood=False)[1]

    def eval_observed_params(self, params, z: Dict[str, Tensor],
                             given: Optional[Dict[str, Tensor]] = None) -> Dict[str, Dict[str, Tensor]]:
        """Distribution parameters of each OBSERVED variable at latent z
        (unconstrained) — what the GLM recognizer probes."""
        store = self._as_store(params)
        given = given or {}
        values: Dict[str, Tensor] = {}
        out: Dict[str, Dict[str, Tensor]] = {}
        for v in self.order:
            if isinstance(v, DeterministicVariable):
                values[v.name] = v.compute(values, store)
                continue
            p = self._params(v, values, store)
            if v.name in given:
                values[v.name] = store.const(torch.as_tensor(given[v.name]))
                continue
            if v.is_observed:
                values[v.name] = self._observed_value(v, values, store)
                out[v.name] = p
                continue
            values[v.name] = self._latent_value(v, p, z)[0]
        return out

    def constrain(self, params, z: Dict[str, Tensor],
                  given: Optional[Dict[str, Tensor]] = None) -> Dict[str, Tensor]:
        """Map unconstrained latents ``z`` to constrained values for every
        variable (deterministic and observed nodes included)."""
        return self._walk_z(self._as_store(params), z, given or {}, with_log_prob=False)[0]

    def unconstrain(self, params, values: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Map constrained latent values into unconstrained space."""
        store = self._as_store(params)
        walk_values: Dict[str, Tensor] = {}
        z: Dict[str, Tensor] = {}
        for v in self.order:
            if isinstance(v, DeterministicVariable):
                walk_values[v.name] = v.compute(walk_values, store)
                continue
            if v.is_observed and v.name not in values:
                walk_values[v.name] = self._observed_value(v, walk_values, store)
                continue
            if v.name not in values:
                continue
            val = store.const(torch.as_tensor(values[v.name]))
            walk_values[v.name] = val
            if v.name in self.continuous_latent_names:
                tr = transform_for(v.distribution, self._params(v, walk_values, store))
                z[v.name] = tr.inverse(val)
        return z

    def z_example(self, dtype=torch.float32) -> Dict[str, Tensor]:
        """Zero tensors with the unconstrained-latent shapes."""
        return {k: torch.zeros(s, dtype=dtype, device=self.device) for k, s in self.z_shapes.items()}

    # ------------------------------------------------------------------
    # Flat layout (ravel_pytree order)
    # ------------------------------------------------------------------
    def ravel_z(self, z: Dict[str, Tensor]) -> Tensor:
        """{name: [..., *shape]} -> [..., dim] (leading batch dims kept)."""
        parts = []
        for name, shape, _, size in self._layout:
            t = z[name]
            lead = t.shape[: t.dim() - len(shape)]
            parts.append(t.reshape(tuple(lead) + (size,)))
        return torch.cat(parts, dim=-1)

    def unravel_z(self, flat: Tensor) -> Dict[str, Tensor]:
        """[..., dim] -> {name: [..., *shape]} (views of ``flat``)."""
        lead = tuple(flat.shape[:-1])
        return {
            name: flat[..., off:off + size].reshape(lead + shape)
            for name, shape, off, size in self._layout
        }

    # ------------------------------------------------------------------
    def sample(self, params, generator, n: int,
               given: Optional[Dict[str, Tensor]] = None) -> Dict[str, Tensor]:
        """``n`` ancestral draws stacked on a leading axis.  ``given``
        entries shaped [n, ...] map over the draws, others broadcast.
        Draws run one after another: the sampler calls this once per run
        (prior initialisation), not in a loop."""
        gen = make_generator(generator, self.device)
        store = self._as_store(params)
        given = dict(given or {})
        mapped = {
            k: torch.as_tensor(v) for k, v in given.items()
            if k in self.shapes and tuple(torch.as_tensor(v).shape) == (n,) + self.shapes[k]
        }
        draws = []
        for i in range(n):
            g = {k: (mapped[k][i] if k in mapped else v) for k, v in given.items()}
            draws.append(self._walk_sample(store, gen, g))
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
