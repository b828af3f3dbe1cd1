"""DAG -> tensor-function compiler.

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
  * ``log_prob_one`` / ``log_likelihood_one`` / ``log_prob`` — the
    constrained-space densities SVI's guides and estimators use (lines
    383-411, 1955), over the walks ``_walk_log_prob`` and ``_walk_mean``
    (lines 292-314, 355-369)
  * ``pointwise_log_likelihood`` — the per-datapoint log-likelihood of
    each observed variable, for WAIC and PSIS-LOO (lines 413-445)
  * ``data_loader_names`` / ``sample_subgraph_one`` — the minibatch draw
    SVI makes every step (lines 1877-1911)

There is no trace step: the walks run eagerly, and a chain axis is added
with ``torch.func.vmap`` by the caller.  The walks therefore avoid
``.item()``, in-place ops and Python branches on tensor values.

Flat latents follow ``jax.flatten_util.ravel_pytree`` of the JAX
package: the continuous latents in SORTED name order, each flattened
row-major (``ravel_z`` / ``unravel_z``).

A plate over an event-valued distribution (MVN, Dirichlet, Concrete)
broadcasts each parameter's batch prefix and keeps its event suffix
(``param_event_ndims``).  A flow-transformed variable
(``transformations.TransformedDistribution``) is drawn with its density
in one pass (``sample_and_log_prob``), as in the JAX walk.

A variable's ``log_prob_mask`` (missing data, set by
``stochastic_processes.observe_timeseries``) multiplies its elementwise
log-prob before the sum, as in the JAX compiler (lines 243-253).

The discrete-enumeration stack of the JAX compiler (compiler.py:526-1848),
which sums Bernoulli and Categorical latents out of ``log_density_z``, is
mixed in from ``enumeration.py`` under JAX's method names
(``enum_log_density_fn`` dispatches); without it a discrete latent that is
not ``given`` raises in ``_latent_value``, as in JAX.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .config import make_generator, resolve_device
from .enumeration import EnumerationMixin
from .transforms import transform_for
from .variables import (
    DeterministicVariable,
    ParamStore,
    PartialLink,
    ProbabilisticModel,
    RandomVariable,
    Variable,
    ancestral_closure,
    full_deps,
)

Tensor = torch.Tensor


class CompiledModel(EnumerationMixin):
    """Frozen lowering of a ProbabilisticModel onto one device (default
    ``config.device``, as for every entry point)."""

    def __init__(self, model: ProbabilisticModel, device=None):
        dev = resolve_device(device)
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
        probe_vals, _ = self._walk_sample(store, make_generator(0, dev), {})
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
        dist = v.distribution
        plate = tuple(v.plate_shape)
        if dist.event_ndim == 0:
            shape = torch.broadcast_shapes(*(p.shape for p in params.values())) if params else ()
            return {k: torch.broadcast_to(p, plate + tuple(shape)) for k, p in params.items()}
        # event-valued distributions (MVN, Dirichlet, Concrete): each
        # parameter keeps its own event suffix (``param_event_ndims``), the
        # batch prefixes broadcast to a common shape, and everything tiles
        # across the plate (JAX compiler.py:216-240)
        evr = dict(dist.param_event_ndims or {})
        ranks = {k: evr.get(k, dist.event_ndim) for k in params}
        common = torch.broadcast_shapes(*(p.shape[:p.dim() - ranks[k]] for k, p in params.items()))
        return {k: torch.broadcast_to(p, plate + tuple(common) + tuple(p.shape[p.dim() - ranks[k]:]))
                for k, p in params.items()}

    def _rv_log_prob(self, v: RandomVariable, value, dist_params, store: ParamStore) -> Tensor:
        lp = v.distribution.log_prob(value, **dist_params)
        mask = getattr(v, "log_prob_mask", None)
        if mask is not None:
            # missing data (stochastic_processes.observe_timeseries): masked
            # terms drop out before the sum, as in the JAX compiler
            lp = lp * store.const(mask)
        lp = torch.sum(lp)
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
    def _walk_sample(self, store: ParamStore, generator: Optional[torch.Generator],
                     given: Dict[str, Tensor], noise: Optional[Dict[str, Tensor]] = None,
                     ) -> Tuple[Dict[str, Tensor], Tensor]:
        """Ancestral sampling walk: (values, log-joint of the sampled and
        ``given`` random variables).  A variable with an entry in ``noise``
        is drawn from it (``from_noise``), the others from ``generator``."""
        values: Dict[str, Tensor] = {}
        logp = torch.zeros((), device=self.device)
        noise = noise or {}
        for v in self.order:
            if v.name in given:
                values[v.name] = store.const(torch.as_tensor(given[v.name]))
                if isinstance(v, RandomVariable):
                    p = self._params(v, values, store)
                    logp = logp + self._rv_log_prob(v, values[v.name], p, store)
                continue
            if isinstance(v, DeterministicVariable):
                values[v.name] = v.compute(values, store)
                continue
            p = self._params(v, values, store)
            dist = v.distribution
            if hasattr(dist, "sample_and_log_prob"):
                # a flow-transformed variable: its density accumulates along
                # the sampling direction (JAX compiler.py:280-284)
                if v.name in noise:
                    value, lp = dist.from_noise_and_log_prob(noise[v.name], **p)
                else:
                    value, lp = dist.sample_and_log_prob(generator, **p)
                values[v.name] = value
                logp = logp + (v.log_prob_scale * lp if v.log_prob_scale != 1.0 else lp)
                continue
            if v.name in noise:
                value = dist.from_noise(noise[v.name], **p)
            else:
                value = dist.sample(generator, **p)
            values[v.name] = value
            logp = logp + self._rv_log_prob(v, value, p, store)
        return values, logp

    def _walk_log_prob(self, store: ParamStore, values_in: Dict[str, Tensor]) -> Tensor:
        """Log-joint of the provided latent (and optionally observed) values;
        deterministic nodes are recomputed where ``values_in`` lacks them."""
        values: Dict[str, Tensor] = {}
        logp = torch.zeros((), device=self.device)
        for v in self.order:
            if isinstance(v, DeterministicVariable):
                values[v.name] = values_in[v.name] if v.name in values_in else v.compute(values, store)
                continue
            p = self._params(v, values, store)
            if v.name in values_in:
                value = values_in[v.name]
            elif v.is_observed:
                value = self._observed_value(v, values, store)
            else:
                raise ValueError(f"latent variable {v.name!r} missing from sample dict")
            values[v.name] = value
            logp = logp + self._rv_log_prob(v, value, p, store)
        return logp

    def _walk_mean(self, store: ParamStore, given: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Every random variable at its mean (the first-order Taylor point
        of ``Taylor1Estimator``)."""
        values: Dict[str, Tensor] = {}
        for v in self.order:
            if v.name in given:
                values[v.name] = store.const(torch.as_tensor(given[v.name]))
            elif isinstance(v, DeterministicVariable):
                values[v.name] = v.compute(values, store)
            else:
                values[v.name] = v.distribution.mean(**self._params(v, values, store))
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
                    lp_lik = lp_lik + self._rv_log_prob(v, values[v.name], p, store)
                continue
            p = self._params(v, values, store) if (with_log_prob or v.name in z) else None
            if v.name in given:
                value = store.const(torch.as_tensor(given[v.name]))
                values[v.name] = value
                if with_log_prob:
                    lp_prior = lp_prior + self._rv_log_prob(v, value, p, store)
                continue
            x, ld = self._latent_value(v, p, z)
            values[v.name] = x
            if with_log_prob:
                lp_prior = lp_prior + self._rv_log_prob(v, x, p, store) + ld
        return values, lp_prior, lp_lik

    # ------------------------------------------------------------------
    # Public per-sample API
    # ------------------------------------------------------------------
    def sample_one(self, params, generator=None, given: Optional[Dict[str, Tensor]] = None):
        """One ancestral draw: {name: value} for every variable, with
        ``given`` entries clamped."""
        gen = make_generator(generator, self.device)
        return self._walk_sample(self._as_store(params), gen, given or {})[0]

    def log_prob_one(self, params, values: Dict[str, Tensor]) -> Tensor:
        """Joint log-density of ONE full assignment in constrained space
        (deterministic nodes recomputed when absent from ``values``)."""
        return self._walk_log_prob(self._as_store(params), values)

    def log_likelihood_one(self, params, values: Dict[str, Tensor]) -> Tensor:
        """Sum of the OBSERVED variables' log-probs only."""
        store = self._as_store(params)
        walk_values: Dict[str, Tensor] = {}
        lp = torch.zeros((), device=self.device)
        for v in self.order:
            if isinstance(v, DeterministicVariable):
                walk_values[v.name] = (values[v.name] if v.name in values
                                       else v.compute(walk_values, store))
                continue
            p = self._params(v, walk_values, store)
            if v.is_observed and v.name not in values:
                walk_values[v.name] = self._observed_value(v, walk_values, store)
                lp = lp + self._rv_log_prob(v, walk_values[v.name], p, store)
            elif v.name in values:
                walk_values[v.name] = values[v.name]
                if v.is_observed:
                    lp = lp + self._rv_log_prob(v, values[v.name], p, store)
            else:
                raise ValueError(f"latent {v.name!r} missing from values")
        return lp

    def pointwise_log_likelihood(self, params, values: Dict[str, Tensor],
                                 given: Optional[Dict[str, Tensor]] = None) -> Dict[str, Tensor]:
        """Elementwise log-likelihood of each OBSERVED variable at the
        constrained latent ``values``: the per-datapoint terms WAIC and
        PSIS-LOO read (``model_comparison.py``).  ``log_prob_scale`` and the
        missing-data mask multiply elementwise (a masked point reads 0; the
        caller drops it)."""
        store = self._as_store(params)
        given = {k: store.const(torch.as_tensor(g)) for k, g in (given or {}).items()}
        walk_values: Dict[str, Tensor] = dict(given)
        out: Dict[str, Tensor] = {}
        for v in self.order:
            if v.name in given:
                continue
            if isinstance(v, DeterministicVariable):
                walk_values[v.name] = v.compute(walk_values, store)
                continue
            p = self._params(v, walk_values, store)
            if v.is_observed and v.name not in values:
                value = self._observed_value(v, walk_values, store)
                walk_values[v.name] = value
                lp = v.distribution.log_prob(value, **p)
                mask = getattr(v, "log_prob_mask", None)
                if mask is not None:
                    lp = lp * store.const(mask)
                if v.log_prob_scale != 1.0:
                    lp = v.log_prob_scale * lp
                out[v.name] = lp
            elif v.name in values:
                walk_values[v.name] = values[v.name]
            else:
                raise ValueError(f"latent {v.name!r} missing from values")
        return out

    def log_prob(self, params, values: Dict[str, Tensor]) -> Tensor:
        """Joint log-density over a leading batch axis of ``values``
        (``torch.func.vmap`` of ``log_prob_one``; unknown names ignored)."""
        names = set(self.names)
        values = {k: torch.as_tensor(v, device=self.device) for k, v in values.items() if k in names}
        return torch.func.vmap(lambda vals: self.log_prob_one(params, vals))(values)

    @property
    def data_loader_names(self) -> List[str]:
        """The data-loader variables (Empirical / RandomIndices), which SVI
        resamples every step to draw its minibatch."""
        from .distributions import Empirical, RandomIndices

        return [v.name for v in self.order if isinstance(v, RandomVariable)
                and isinstance(v.distribution, (Empirical, RandomIndices))]

    def sample_subgraph_one(self, params, generator, names: Sequence[str]) -> Dict[str, Tensor]:
        """Draw only ``names`` and their ancestors (the minibatch draw)."""
        store = self._as_store(params)
        gen = make_generator(generator, self.device)
        needed = set(names)
        for v in reversed(self.order):  # ancestors, by a reverse topological sweep
            if v.name in needed:
                needed.update(p.name for p in full_deps(v))
        values: Dict[str, Tensor] = {}
        for v in self.order:
            if v.name not in needed:
                continue
            if isinstance(v, DeterministicVariable):
                values[v.name] = v.compute(values, store)
            else:
                values[v.name] = v.distribution.sample(gen, **self._params(v, values, store))
        return values

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
            draws.append(self._walk_sample(store, gen, g)[0])
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


def compile_model(model: ProbabilisticModel, device=None, **kwargs) -> CompiledModel:
    """``CompiledModel(model, device)``; other keywords are accepted and
    ignored, as in the JAX package (``compiler.py:1962``)."""
    del kwargs
    return CompiledModel(model, device=device)
