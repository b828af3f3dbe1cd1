"""Exact enumeration of discrete latents: the compiler's enumeration stack.

Counterpart of ``brancher_tpu/compiler.py:65-146`` (the elimination
helpers) and ``:526-1848`` (the ``CompiledModel`` methods), mixed into the
port's ``CompiledModel`` under JAX's method names.  Bernoulli and
Categorical latents that are not ``given`` are summed out of the log
density in unconstrained space, so NUTS, HMC and SVI run on the marginal
of the continuous latents.  ``enum_log_density_fn`` picks the path, in
JAX's order:

  * ``sequence_enumerated_log_density`` — MarkovSeries chains with a
    Bernoulli or Categorical transition: the forward algorithm over
    tables built from O(K^2) vectorized evaluations;
  * ``enumerated_log_density`` — element-wise independent latents: one
    logsumexp per element over a batch of full-density evaluations;
  * ``chain_enumerated_log_density`` — a pairwise chain of scalar latents
    (an unrolled DSL HMM): the forward algorithm over structural tables;
  * ``factor_enumerated_log_density`` — any interaction graph of scalar
    latents: variable elimination in min-fill order;
  * ``group_enumerated_log_density`` — plated latents that interact
    element-wise across one shared plate.

Differences from JAX, each for the same reason: the returned density runs
eagerly on every call, inside ``torch.func.vmap`` over the chains and
inside the CUDA graph that ``hmc.GraphedValueAndGrad`` replays, so it may
read nothing back from the card and draw no random number.  So:

  * everything structural is worked out once per set of ``given`` names
    and shapes and cached: the latents' names, shapes and cardinalities
    (read from a walk at z = 0 with every latent at 0, not from a random
    draw), the interaction structure, the assignment blocks, and which
    table path each group takes;
  * the ``check_*`` probes (host reads by design) run at dispatch, and
    their verdicts are cached as in JAX;
  * assignments are int64, torch's index type (JAX uses int32), and each
    batch of assignments is built directly as an [N, *shape] block (the
    reference repeated, the diagonal scattered) and mapped through the
    density with ``torch.func.vmap``;
  * each ``lax.scan`` over time is a Python loop over T.
"""
from __future__ import annotations

import itertools
import math
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .transforms import transform_for
from .variables import DeterministicVariable, PartialLink, RandomVariable, Variable, full_deps

Tensor = torch.Tensor
_INT = torch.int64


def _min_fill_order(names: List[str], scopes: List[Tuple[str, ...]]) -> List[str]:
    """Min-fill elimination order over the factor interaction graph
    (greedy: eliminate the variable whose neighbours need the fewest new
    edges)."""
    adj: Dict[str, set] = {n: set() for n in names}
    for sc in scopes:
        for a, b in itertools.combinations(sc, 2):
            adj[a].add(b)
            adj[b].add(a)
    remaining = set(names)
    order: List[str] = []
    while remaining:
        best, best_fill = None, None
        for n in names:
            if n not in remaining:
                continue
            nb = adj[n] & remaining
            fill = sum(1 for a, b in itertools.combinations(sorted(nb), 2) if b not in adj[a])
            if best_fill is None or fill < best_fill:
                best, best_fill = n, fill
        nb = adj[best] & remaining
        for a, b in itertools.combinations(nb, 2):
            adj[a].add(b)
            adj[b].add(a)
        remaining.discard(best)
        order.append(best)
    return order


def _broadcast_table(names: Tuple[str, ...], table: Tensor, union: List[str]) -> Tensor:
    """A log-table with its axes in ``union``'s order (size-1 axes for the
    variables outside its scope)."""
    pos = [union.index(n) for n in names]
    perm = sorted(range(len(names)), key=lambda i: pos[i])
    t = table.permute(*perm) if perm else table
    sorted_pos = sorted(pos)
    shape, j = [], 0
    for i in range(len(union)):
        if j < len(sorted_pos) and sorted_pos[j] == i:
            shape.append(t.shape[j])
            j += 1
        else:
            shape.append(1)
    return t.reshape(shape)


def _eliminate_tables(tables: List[Tuple[Tuple[str, ...], Tensor]], order: List[str],
                      like: Tensor) -> Tensor:
    """Sum-product variable elimination in the log domain: log of the sum
    over every joint assignment of exp(sum of the table entries)."""
    tabs = list(tables)
    const = torch.zeros((), dtype=like.dtype, device=like.device)
    for d in order:
        group = [t for t in tabs if d in t[0]]
        tabs = [t for t in tabs if d not in t[0]]
        if not group:
            continue
        union: List[str] = []
        for names, _ in group:
            for n in names:
                if n not in union:
                    union.append(n)
        big = None
        for names, table in group:
            bt = _broadcast_table(names, table, union)
            big = bt if big is None else big + bt
        summed = torch.logsumexp(big, dim=union.index(d))
        rest = tuple(n for n in union if n != d)
        if rest:
            tabs.append((rest, summed))
        else:
            const = const + summed
    return const


def _forward(alpha0: Tensor, psi: Tensor, u: Tensor, shared: bool = False) -> List[Tensor]:
    """The log-space forward recursion alpha_t[k] = lse_j(alpha_{t-1}[j] +
    psi_t[j, k]) + u[t, k] for t >= 1 (``u[0]`` is folded into
    ``alpha0`` by the caller).  ``psi`` is [T-1, ..., K, K], or one
    [..., K, K] table for every step when ``shared``; ``u`` is [T, ..., K].
    Returns [alpha_0, ..., alpha_{T-1}].  The steps read ``unbind`` views,
    whose backward stacks the T gradients once (indexing u[t] would add a
    full-size gradient per step: O(T^2))."""
    alphas = [alpha0]
    a = alpha0
    us = u.unbind(0)
    psis = None if shared else psi.unbind(0)
    for t in range(1, len(us)):
        a = torch.logsumexp(a.unsqueeze(-1) + (psi if shared else psis[t - 1]), dim=-2) + us[t]
        alphas.append(a)
    return alphas


def _backward(psi: Tensor, u: Tensor, shared: bool = False) -> List[Tensor]:
    """The matching backward recursion beta_{t-1}[j] = lse_k(psi_t[j, k] +
    u[t, k] + beta_t[k]), beta_{T-1} = 0; returns [beta_0, ..., beta_{T-1}]."""
    us = u.unbind(0)
    psis = None if shared else psi.unbind(0)
    beta = torch.zeros_like(us[0])
    betas = [beta]
    for t in range(len(us) - 1, 0, -1):
        beta = torch.logsumexp((psi if shared else psis[t - 1]) + (us[t] + beta).unsqueeze(-2),
                               dim=-1)
        betas.append(beta)
    betas.reverse()
    return betas


def _given_sig(given: Dict[str, Tensor]) -> tuple:
    """The names and shapes of ``given``: what the structural caches are
    keyed by (values never change a shape, a cardinality or a layout)."""
    return tuple(sorted((k, tuple(torch.as_tensor(v).shape)) for k, v in given.items()))


def _rows_with_diagonal(n_elem: int, values: Tensor) -> Tensor:
    """[n_elem * len(values), n_elem] int64: row e * len(values) + m is all
    zeros but element e, which holds values[m]."""
    m = values.shape[0]
    blk = torch.zeros((n_elem * m, n_elem), dtype=_INT, device=values.device)
    rows = torch.arange(n_elem * m, device=values.device)
    cols = torch.arange(n_elem, device=values.device).repeat_interleave(m)
    blk[rows, cols] = values.repeat(n_elem)
    return blk


class EnumerationMixin:
    """The enumeration methods of ``CompiledModel`` (module docstring)."""

    # -- caches ---------------------------------------------------------
    def _cache(self, name: str) -> dict:
        return self.__dict__.setdefault(name, {})

    def _const_block(self, key, build):
        """A constant tensor (an assignment block, a reference), built once
        on the model's device."""
        cache = self._cache("_enum_const_cache")
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def _var(self, name: str) -> Variable:
        return next(w for w in self.order if w.name == name)

    def _ref(self, info, given_sig) -> Dict[str, Tensor]:
        """The all-zeros reference assignment of the enumerated latents."""
        return self._const_block(("ref", given_sig), lambda: {
            n: torch.zeros(s, dtype=_INT, device=self.device) for n, s, _k in info})

    def _combo_grid(self, ks) -> Tensor:
        """[prod(ks), len(ks)] int64 cartesian product (row 0 all zero)."""
        def build():
            if not ks:
                return torch.zeros((1, 0), dtype=_INT, device=self.device)
            grids = torch.meshgrid(*[torch.arange(k, dtype=_INT, device=self.device)
                                     for k in ks], indexing="ij")
            return torch.stack([g.reshape(-1) for g in grids], dim=1)

        return self._const_block(("grid", tuple(ks)), build)

    def _zero_walk_values(self, store, given):
        """Every value at z = 0 with each discrete latent outside ``given``
        at 0: a walk that draws nothing, for reading parameter shapes."""
        ref = {n: torch.zeros(self.shapes[n], dtype=_INT, device=self.device)
               for n in self.discrete_latent_names if n not in given}
        return self._walk_z(store, self.z_example(), {**given, **ref}, with_log_prob=False)[0]

    # -- element-wise enumeration (JAX compiler.py:528-662) --------------
    def discrete_enum_info(self, params, given=None):
        """[(name, shape, cardinality)] of every enumerable discrete latent
        outside ``given`` (Bernoulli K=2; Categorical K = the trailing class
        axis of its parameters).  Cached per ``given`` names and shapes."""
        from .distributions import Bernoulli, Categorical

        given = given or {}
        key = _given_sig(given)
        cache = self._cache("_enum_info_cache")
        if key in cache:
            return cache[key]
        store = self._as_store(params)
        values = None
        info = []
        for v in self.order:
            if v.name not in self.discrete_latent_names or v.name in given:
                continue
            if isinstance(v.distribution, Bernoulli):
                k = 2
            elif isinstance(v.distribution, Categorical):
                if values is None:
                    values = self._zero_walk_values(store, given)
                p = self._params(v, values, store)
                lg = p["logits"] if "logits" in p else p["probs"]
                k = int(lg.shape[-1])
            else:
                raise ValueError(
                    f"discrete latent {v.name!r} ({type(v.distribution).__name__}) "
                    "is not enumerable (Bernoulli/Categorical only)")
            info.append((v.name, tuple(self.shapes[v.name]), k))
        cache[key] = info
        return info

    def _elementwise_block(self, name, shape, k) -> Tensor:
        """[E * K, *shape]: the reference with element e set to k, row e*K+k."""
        n_elem = math.prod(shape)
        return self._const_block(("elementwise", name, shape, k), lambda: _rows_with_diagonal(
            n_elem, torch.arange(k, dtype=_INT, device=self.device)).reshape((n_elem * k,) + shape))

    def enumerated_log_density(self, params, z: Dict[str, Tensor],
                               given: Optional[Dict[str, Tensor]] = None,
                               return_responsibilities: bool = False):
        """log p(z, data) with every discrete latent summed out, for latents
        whose terms are additive over their elements:
        ``logp(z, d) = C(z) + sum_(i,e) f_ie(d[i][e], z)`` (checked by
        ``check_enum_factorization``), so the marginal is
        ``C + sum_(i,e) logsumexp_k (lp_ie(k) - base)`` from one batch of
        full-density evaluations per latent (the sum of the cardinalities,
        not their product).  With ``return_responsibilities`` also
        ``{name: [*shape, K]}`` posterior probabilities per element."""
        given = dict(given or {})
        info = self.discrete_enum_info(params, given)
        ref = self._ref(info, _given_sig(given))

        def lp_with(assign):
            return self.log_density_z(params, z, {**given, **ref, **assign})

        base = lp_with({})
        total = base
        resp = {}
        for name, shape, k in info:
            n_elem = math.prod(shape)
            blk = self._elementwise_block(name, shape, k)
            lps = torch.func.vmap(lambda d, _n=name: lp_with({_n: d}))(blk).reshape(n_elem, k)
            rel = lps - base
            total = total + torch.sum(torch.logsumexp(rel, dim=1))
            if return_responsibilities:
                resp[name] = torch.softmax(rel, dim=1).reshape(shape + (k,))
        if return_responsibilities:
            return total, resp
        return total

    def _random_z(self, rng) -> Dict[str, Tensor]:
        return {n: torch.as_tensor(rng.normal(0, 0.7, s).astype(np.float32), device=self.device)
                for n, s in self.z_shapes.items()}

    @staticmethod
    def _int(x) -> Tensor:
        return torch.as_tensor(np.asarray(x), dtype=_INT)

    def _verdict(self, cache_name, params, given, impl):
        given = dict(given or {})
        gk = frozenset(given.keys())
        cacheable = params is self.initial_params
        cache = self._cache(cache_name)
        if cacheable and gk in cache:
            return cache[gk]
        verdict = impl(params, given)
        if cacheable:
            cache[gk] = verdict
        return verdict

    def check_enum_factorization(self, params, given=None, atol=1e-3) -> bool:
        """Numerical check of the element-wise additivity the element-wise
        enumeration relies on: logp at a joint assignment must equal the
        sum of single-element deviations from the all-zeros reference.
        False for models with discrete-discrete interactions; a structural
        pre-filter answers without a probe when some term touches two
        discrete latents.  The verdict is cached per ``given`` names when
        ``params`` is ``initial_params``."""
        return self._verdict("_enum_verdict_cache", params, given,
                             lambda p, g: self._check_enum_factorization_impl(p, g, atol))

    def _check_enum_factorization_impl(self, params, given, atol) -> bool:
        info = self.discrete_enum_info(params, given)
        if not info:
            return True
        struct = self._discrete_structure(frozenset(given.keys()))
        if any(len(deps) > 1 for _v, deps in struct["terms"]):
            return False  # structural cross-latent interaction
        rng = np.random.RandomState(0)
        z = self._random_z(rng)
        ref = self._ref(info, _given_sig(given))

        def lp_with(assign):
            return float(self.log_density_z(params, z, {**given, **ref, **assign}))

        base = lp_with({})
        # the all-max probe first: saturating cross-element terms (a product
        # over a plate) break additivity only at dense assignments
        probes = [{n: torch.full(s, k - 1, dtype=_INT) for n, s, k in info}] + [
            {n: self._int(rng.randint(0, k, s if s else ())) for n, s, k in info}
            for _ in range(2)]
        for d_star in probes:
            d_star = {n: d.to(self.device) for n, d in d_star.items()}
            joint = lp_with(d_star)
            total = 0.0
            for name, shape, _k in info:
                flat_star = d_star[name].reshape(-1)
                for e in range(math.prod(shape)):
                    d = ref[name].reshape(-1).clone()
                    d[e] = flat_star[e]
                    total += lp_with({name: d.reshape(shape)}) - base
            if abs((joint - base) - total) > atol * max(1.0, abs(joint)):
                return False
        return True

    # -- structural factor extraction (JAX compiler.py:664-878) ----------
    def _discrete_structure(self, given_keys=frozenset()):
        """Static analysis per conditioning-key set, cached:

        * ``value_deps[name]``: the enumerable discrete latents the node's
          value depends on;
        * ``terms``: ``[(RandomVariable, deps)]``, one log-prob term per
          random variable in topological order, with the discrete latents
          its value changes with;
        * ``recompute[name]``: the nodes, in topological order, to evaluate
          again when that variable's term is computed under an assignment
          of its deps other than the reference.

        Dependence flows from a discrete latent through deterministic nodes
        (and through Interval-transformed latents, whose values follow
        their bounds) and stops at every other random variable, so the
        deps are a superset of the true ones and any decomposition derived
        from them is exact."""
        from .distributions import INTERVAL

        given_keys = frozenset(given_keys)
        cache = self._cache("_disc_struct_cache")
        hit = cache.get(given_keys)
        if hit is not None:
            return hit
        disc = {n for n in self.discrete_latent_names if n not in given_keys}
        empty: frozenset = frozenset()
        value_deps: Dict[str, frozenset] = {}
        terms: List[Tuple[RandomVariable, frozenset]] = []
        for v in self.order:
            param_deps = empty
            for pvar in v.parents:
                param_deps = param_deps | value_deps.get(pvar.name, empty)
            obs = getattr(v, "_observed", None)
            obs_deps = empty
            if isinstance(obs, PartialLink):
                for pvar in obs.vars:
                    obs_deps = obs_deps | value_deps.get(pvar.name, empty)
            if isinstance(v, DeterministicVariable):
                value_deps[v.name] = param_deps
                continue
            if v.name in given_keys:
                vdeps = empty
            elif v.is_observed:
                vdeps = obs_deps
            elif v.name in disc:
                vdeps = frozenset({v.name})
            elif not v.distribution.is_discrete and v.distribution.support == INTERVAL:
                # the unconstraining bijection's bounds follow the params,
                # so tr.forward(z) inherits their discrete deps
                vdeps = param_deps
            else:
                vdeps = empty
            value_deps[v.name] = vdeps
            terms.append((v, param_deps | obs_deps | vdeps))

        recompute: Dict[str, List[Variable]] = {}
        for v, deps in terms:
            if not deps:
                recompute[v.name] = []
                continue
            needed: List[Variable] = []
            seen: set = set()

            def visit(w, _deps=deps, _needed=needed, _seen=seen):
                if id(w) in _seen:
                    return
                _seen.add(id(w))
                if not (value_deps.get(w.name, empty) & _deps):
                    return  # value fixed at the reference walk
                if w.name not in disc:
                    # assigned latents take their value directly; every
                    # other dependent node re-walks its own parents
                    for p2 in full_deps(w):
                        visit(p2, _deps, _needed, _seen)
                _needed.append(w)

            for p2 in full_deps(v):
                visit(p2)
            recompute[v.name] = needed
        out = {"value_deps": value_deps, "terms": terms, "recompute": recompute}
        cache[given_keys] = out
        return out

    def _enum_cards(self, params, given=None) -> Dict[str, int]:
        """{name: cardinality} of the enumerable SCALAR discrete latents
        (raises if any has a non-scalar shape)."""
        info = self.discrete_enum_info(params, given)
        for n, shape, _k in info:
            if tuple(shape) != ():
                raise ValueError(f"structural enumeration needs scalar discrete "
                                 f"latents; {n!r} has shape {shape}")
        return {n: k for n, _s, k in info}

    def _recompute_walk(self, needed, assign, base_vals, store, z):
        """The values after re-evaluating ``needed`` under ``assign``."""
        vals = dict(base_vals)
        vals.update(assign)
        for w in needed:
            if w.name in assign:
                continue
            if isinstance(w, DeterministicVariable):
                vals[w.name] = w.compute(vals, store)
            elif isinstance(w, RandomVariable) and w.is_observed:
                vals[w.name] = self._observed_value(w, vals, store)
            else:
                # an Interval-transformed latent: its value follows the
                # (assignment-dependent) bounds
                tr = transform_for(w.distribution, self._params(w, vals, store))
                vals[w.name] = tr.forward(z[w.name])
        return vals

    def _term_table(self, v, deps, struct, store, base_vals, z, cards):
        """Log-factor table of ``v``'s term over its discrete deps (axes in
        the latents' topological order).  Each entry re-walks only
        ``recompute[v]``: O(1) nodes, not a full density walk."""
        disc_idx = {n: i for i, n in enumerate(self.discrete_latent_names)}
        names = tuple(sorted(deps, key=lambda n: disc_idx[n]))
        needed = struct["recompute"][v.name]
        vdeps = struct["value_deps"][v.name]

        def term(avec):
            assign = {n: avec[i] for i, n in enumerate(names)}
            vals = self._recompute_walk(needed, assign, base_vals, store, z)
            p = self._params(v, vals, store)
            extra = None
            if v.name in assign:
                value = assign[v.name]
            elif vdeps & set(names):
                if v.is_observed:
                    value = self._observed_value(v, vals, store)
                else:
                    tr = transform_for(v.distribution, p)
                    value = tr.forward(z[v.name])
                    extra = torch.sum(tr.forward_log_det(z[v.name]))
            else:
                value = base_vals[v.name]
            lp = self._rv_log_prob(v, value, p, store)
            return lp if extra is None else lp + extra

        ks = [cards[n] for n in names]
        table = torch.func.vmap(term)(self._combo_grid(ks)).reshape(ks)
        return names, table

    def _structural_factors(self, params, z, given):
        """(constant, [(names, log-table)]) with
        log_density_z(z, {**given, **assignment}) = constant + the sum of
        the tables' entries at the assignment."""
        given = dict(given or {})
        cards = self._enum_cards(params, given)
        struct = self._discrete_structure(frozenset(given.keys()))
        store = self._as_store(params)
        ref = self._ref(self.discrete_enum_info(params, given), _given_sig(given))
        base_vals, lp_prior, lp_lik = self._walk_z(store, z, {**given, **ref})
        const = lp_prior + lp_lik
        tables = []
        for v, deps in struct["terms"]:
            if not deps:
                continue
            names, table = self._term_table(v, deps, struct, store, base_vals, z, cards)
            const = const - table[(0,) * len(names)]
            tables.append((names, table))
        return const, tables

    def factor_enumerated_log_density(self, params, z: Dict[str, Tensor],
                                      given: Optional[Dict[str, Tensor]] = None):
        """log p(z, data) with every scalar discrete latent summed out by
        variable elimination (min-fill order) over the structurally
        extracted local factors: exact for any interaction pattern, at a
        cost exponential only in the induced width."""
        given = dict(given or {})
        cards = self._enum_cards(params, given)
        if not cards:
            return self.log_density_z(params, z, given)
        const, tables = self._structural_factors(params, z, given)
        order = _min_fill_order(list(cards), [t[0] for t in tables])
        return const + _eliminate_tables(tables, order, const)

    # -- group enumeration (JAX compiler.py:880-1177) --------------------
    def _enum_groups(self, given_keys=frozenset()):
        """Connected components of the discrete interaction graph (two
        latents join when a term touches both), each in
        ``discrete_latent_names`` order.  Cached per key set."""
        gk = frozenset(given_keys)
        cache = self._cache("_enum_groups_cache")
        hit = cache.get(gk)
        if hit is not None:
            return hit
        disc = [n for n in self.discrete_latent_names if n not in gk]
        parent = {n: n for n in disc}

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for _v, deps in self._discrete_structure(gk)["terms"]:
            deps = [d for d in deps if d in parent]
            for b in deps[1:]:
                parent[find(deps[0])] = find(b)
        comps: Dict[str, List[str]] = {}
        for n in disc:
            comps.setdefault(find(n), []).append(n)
        groups = tuple(tuple(g) for g in comps.values())
        cache[gk] = groups
        return groups

    @staticmethod
    def _group_layout(grp, shapes, cards):
        """(scalars, plated, s0) split of a group's latents; raises for
        several distinct non-scalar shapes and for more than 256 joint
        states an element."""
        scalars = tuple(n for n in grp if tuple(shapes[n]) == ())
        plated = tuple(n for n in grp if tuple(shapes[n]) != ())
        s0 = tuple(shapes[plated[0]]) if plated else ()
        if any(tuple(shapes[n]) != s0 for n in plated[1:]):
            raise ValueError(
                f"interacting discrete latents {grp} have several distinct "
                "non-scalar shapes; group enumeration handles scalars plus ONE "
                "shared plate shape")
        a = math.prod(cards[n] for n in scalars)
        m = math.prod(cards[n] for n in plated)
        if a * m > 256:
            raise ValueError(
                f"discrete group {grp} has {a * m} joint states per element "
                "(cap 256); break the interaction or marginalize by hand")
        return scalars, plated, s0

    def _group_tables_structural(self, grp, scalars, plated, s0, struct, store, base_vals,
                                 z, cards):
        """(rel_scal [A], rel_elem [A, M, E]) relative log-tables of the
        group's terms from structurally extracted local evaluations:
        scalar-only terms through ``_term_table``, plated terms through
        ``_term_vec_fn`` with every plate element at one combination (one
        [E] evaluation in place of E probes).  Raises ValueError when a
        term's log-prob shape cannot be aligned to the plate."""
        e_n = math.prod(s0)
        a_n = math.prod(cards[n] for n in scalars)
        m_n = math.prod(cards[n] for n in plated)
        combos_a = self._combo_grid([cards[n] for n in scalars])
        combos_m = self._combo_grid([cards[n] for n in plated])
        grp_set = set(grp)
        rel_scal = torch.zeros((a_n,), device=self.device)
        rel_elem = torch.zeros((a_n, m_n, e_n), device=self.device)
        for v2, deps in struct["terms"]:
            d = deps & grp_set
            if not d:
                continue
            if d <= set(scalars):
                names, table = self._term_table(v2, deps, struct, store, base_vals, z, cards)
                idx = tuple(combos_a[:, scalars.index(n)] for n in names)
                rel_scal = rel_scal + (table[idx] - table[(0,) * len(names)])
                continue
            fn = self._term_vec_fn(v2, struct, store, base_vals, z, s0)

            def eval_am(av, mv, _fn=fn):
                assign = {n: av[j] for j, n in enumerate(scalars)}
                assign.update({n: mv[i].expand(s0) for i, n in enumerate(plated)})
                return _fn(assign)

            aa, mm = self._const_block(("group_am", grp), lambda: (
                combos_a.repeat_interleave(m_n, dim=0), combos_m.repeat(a_n, 1)))  # [A*M, S|P]
            vecs = torch.func.vmap(eval_am)(aa, mm).reshape(a_n, m_n, e_n)
            rel_elem = rel_elem + (vecs - vecs[0, 0][None, None, :])
        return rel_scal, rel_elem

    def _group_plan(self, params, given):
        """{group: (scalars, plated, s0, structural)} per ``given`` names
        and shapes, cached.  Whether a group's tables come from the
        structural extractor is decided here, once, by building them at
        z = 0; the probe fallback covers groups without scalar latents."""
        key = _given_sig(given)
        cache = self._cache("_group_plan_cache")
        if key in cache:
            return cache[key]
        info = self.discrete_enum_info(params, given)
        shapes = {n: s for n, s, _k in info}
        cards = {n: k for n, _s, k in info}
        gk = frozenset(given.keys())
        struct = self._discrete_structure(gk)
        store = self._as_store(params)
        ref = self._ref(info, key)
        plan = {}
        with torch.no_grad():
            base_vals = self._walk_z(store, self.z_example(), {**given, **ref},
                                     with_log_prob=False)[0]
            for grp in self._enum_groups(gk):
                scalars, plated, s0 = self._group_layout(grp, shapes, cards)
                try:
                    self._group_tables_structural(grp, scalars, plated, s0, struct, store,
                                                  base_vals, self.z_example(), cards)
                    structural = True
                except ValueError:
                    if scalars:
                        raise  # the probe fallback covers shared-shape groups only
                    structural = False
                plan[grp] = (scalars, plated, s0, structural)
        cache[key] = plan
        return plan

    def group_enumerated_log_density(self, params, z: Dict[str, Tensor],
                                     given: Optional[Dict[str, Tensor]] = None,
                                     return_responsibilities: bool = False):
        """log p(z, data) with plated interacting discrete latents summed
        out per element.  The latents fall into interaction groups
        (``_enum_groups``); a group may mix scalar latents with plated ones
        of ONE shared plate shape.  With ``logp(z, a, d) = C(z) + T(a, z) +
        sum_e f_e(a, d_e, z)`` over the group's scalar joint assignment a
        and plate elements e (checked by ``check_group_factorization``),
        the marginal is ``C + lse_a [T(a) + sum_e lse_m f_e(a, m)]``.  With
        ``return_responsibilities`` also each latent's posterior marginals
        ``{name: [*shape, K]}`` (a scalar latent: [K])."""
        given = dict(given or {})
        info = self.discrete_enum_info(params, given)
        cards = {n: k for n, _s, k in info}
        plan = self._group_plan(params, given)
        struct = self._discrete_structure(frozenset(given.keys()))
        store = self._as_store(params)
        ref = self._ref(info, _given_sig(given))
        base_vals, lp_prior, lp_lik = self._walk_z(store, z, {**given, **ref})
        base_lp = lp_prior + lp_lik
        total = base_lp
        resp: Dict[str, Tensor] = {}
        for grp, (scalars, plated, s0, structural) in plan.items():
            if structural:
                rel_scal, rel_elem = self._group_tables_structural(
                    grp, scalars, plated, s0, struct, store, base_vals, z, cards)
            else:
                rel_elem = self._group_rel_probe(grp, s0, cards, ref, params, z, given,
                                                 base_lp)[None]  # [1, M, E]
                rel_scal = torch.zeros((1,), device=self.device)
            per_elem = torch.logsumexp(rel_elem, dim=1)  # [A, E]
            w_log = rel_scal + torch.sum(per_elem, dim=-1)  # [A]
            total = total + torch.logsumexp(w_log, dim=0)
            if return_responsibilities:
                p_a = torch.softmax(w_log, dim=0)
                p_me = torch.softmax(rel_elem, dim=1)
                combos_a = self._combo_grid([cards[n] for n in scalars])
                combos_m = self._combo_grid([cards[n] for n in plated])
                for i, n in enumerate(plated):
                    onehot = torch.nn.functional.one_hot(combos_m[:, i], cards[n]).to(p_a.dtype)
                    marg = torch.einsum("a,ame,mk->ek", p_a, p_me, onehot)
                    resp[n] = marg.reshape(s0 + (cards[n],))
                for j, n in enumerate(scalars):
                    onehot = torch.nn.functional.one_hot(combos_a[:, j], cards[n]).to(p_a.dtype)
                    resp[n] = p_a @ onehot
        if return_responsibilities:
            return total, resp
        return total

    def _group_rel_probe(self, grp, s0, cards, ref, params, z, given, base):
        """Probe-based relative table [M, E]: one batch of E * prod(K)
        full-density evaluations, for terms whose log-prob shape the
        structural extractor cannot align to the plate."""
        ks = [cards[n] for n in grp]
        m = math.prod(ks)
        n_elem = math.prod(s0)
        combos = self._combo_grid(ks)
        blocks = [self._const_block(("group_probe", grp, i), lambda i=i: _rows_with_diagonal(
            n_elem, combos[:, i]).reshape((n_elem * m,) + s0)) for i in range(len(grp))]

        def one(*ds):
            return self.log_density_z(params, z, {**given, **ref, **dict(zip(grp, ds))})

        lps = torch.func.vmap(one)(*blocks).reshape(n_elem, m)  # [E, M]
        return (lps - base).T

    def check_group_factorization(self, params, given=None, atol=1e-3) -> bool:
        """True when every discrete interaction group's joint term is
        additive across plate ELEMENTS (what ``group_enumerated_log_density``
        relies on).  Mixed plate shapes and oversized groups fail
        structurally; the numeric probe then holds logp at joint
        assignments (the all-max one first) to the sum of per-element
        deviations, at two random z.  Cached per ``given`` names."""
        return self._verdict("_group_verdict_cache", params, given,
                             lambda p, g: self._check_group_factorization_impl(p, g, atol))

    def _check_group_factorization_impl(self, params, given, atol) -> bool:
        info = self.discrete_enum_info(params, given)
        if not info:
            return True
        shapes = {n: s for n, s, _k in info}
        cards = {n: k for n, _s, k in info}
        groups = self._enum_groups(frozenset(given.keys()))
        try:
            layouts = {grp: self._group_layout(grp, shapes, cards) for grp in groups}
        except ValueError:
            return False
        rng = np.random.RandomState(0)
        ref = self._ref(info, _given_sig(given))
        for _zdraw in range(2):
            z = self._random_z(rng)

            def lp_with(assign, _z=z):
                return float(self.log_density_z(params, _z, {**given, **ref, **assign}))

            probes = [{n: torch.full(s, k - 1, dtype=_INT) for n, s, k in info}] + [
                {n: self._int(rng.randint(0, k, s if s else ())) for n, s, k in info}
                for _ in range(2)]
            for d_star in probes:
                d_star = {n: d.to(self.device) for n, d in d_star.items()}
                # additivity across plate ELEMENTS at a fixed joint scalar
                # assignment: lp(a*, m*) - lp(a*, ref_m) must equal the sum
                # of single-element deviations from lp(a*, ref_m)
                joint = lp_with(d_star)
                scalar_part = {n: d_star[n] for grp in groups for n in layouts[grp][0]}
                base_a = lp_with(scalar_part)
                total = 0.0
                for grp in groups:
                    _scalars, plated, s0 = layouts[grp]
                    for e in range(math.prod(s0)):
                        assign = dict(scalar_part)
                        for n in plated:
                            d = ref[n].reshape(-1).clone()
                            d[e] = d_star[n].reshape(-1)[e]
                            assign[n] = d.reshape(s0)
                        total += lp_with(assign) - base_a
                if abs((joint - base_a) - total) > atol * max(1.0, abs(joint)):
                    return False
        return True

    # -- dispatch (JAX compiler.py:1179-1272) ----------------------------
    def enum_log_density_fn(self, params, given=None):
        """The fastest exact enumerated density for this model's discrete
        structure, the one entry point ``sample`` and SVI use; cached per
        ``given`` names when ``params`` is ``initial_params``.

        Order: MarkovSeries sequence nodes → element-wise logsumexp →
        forward algorithm on a structural chain → variable elimination (any
        scalar interaction graph) → the numerically verified chain → per-
        element group enumeration.  Every probe runs here; the returned
        callable reads only cached structure, so it may run inside
        ``torch.func.vmap`` and a CUDA graph."""
        given = dict(given or {})
        gk = frozenset(given.keys())
        cacheable = params is self.initial_params
        cache = self._cache("_enum_fn_cache")
        if cacheable and gk in cache:
            return cache[gk]
        if self._sequence_chain_info(params, given) is not None:
            if not self.check_sequence_factorization(params, given):
                raise ValueError(
                    "MarkovSeries discrete chain does not factorize: emission terms "
                    "must be element-wise across the chain's time axis (cross-timestep "
                    "coupling, e.g. a matmul over the series, is not enumerable)")
            fn = self.sequence_enumerated_log_density
        elif self.check_enum_factorization(params, given):
            fn = self.enumerated_log_density
        elif (self.discrete_chain_info(params, given) is not None
              and self.discrete_chain_structure(gk) is not None):
            self._warn_unrolled_enum(gk, chain=True)
            fn = self.chain_enumerated_log_density
        else:
            info = self.discrete_enum_info(params, given)
            if info and all(tuple(s) == () for _n, s, _k in info):
                self._warn_unrolled_enum(gk, chain=False)
                fn = self.factor_enumerated_log_density
            elif self.check_chain_factorization(params, given):
                self._warn_unrolled_enum(gk, chain=True)
                fn = self.chain_enumerated_log_density
            elif self.check_group_factorization(params, given):
                self._group_plan(params, given)
                fn = self.group_enumerated_log_density
            else:
                raise ValueError(
                    "discrete latents do not factorize element-wise: enumeration "
                    "supports element-wise independent latents, Markov chains, general "
                    "SCALAR interaction graphs (variable elimination), and plated "
                    "latents whose interactions are element-wise across one shared "
                    "plate (group enumeration); cross-element coupling (e.g. through a "
                    "matmul) is not enumerable")
        if cacheable:
            cache[gk] = fn
        return fn

    _UNROLLED_ENUM_WARN_AT = 64

    def _warn_unrolled_enum(self, gk, chain: bool) -> None:
        """One warning when the per-node tables of more than 64 unrolled
        scalar latents are about to be built: every node of an unrolled
        chain is its own graph object, so the density's work grows with T
        in Python; a ``MarkovSeries`` sequence node builds its tables with
        O(K^2) vectorized evaluations instead."""
        n = len([x for x in self.discrete_latent_names if x not in gk])
        if n <= self._UNROLLED_ENUM_WARN_AT:
            return
        fix = ("rewrite the chain with stochastic_processes.MarkovSeries (or "
               "GaussianHMM/EmissionHMM), whose sequence-node enumeration builds its "
               "tables with O(K^2) vectorized evaluations" if chain else
               "if the structure is a repeated (chain-like) pattern, rewrite it with "
               "stochastic_processes.MarkovSeries")
        warnings.warn(
            f"enumerating {n} unrolled discrete latents builds O(T) per-node tables "
            f"on every call — the density's host work grows with the chain length; {fix}",
            stacklevel=4)

    # -- chain enumeration (JAX compiler.py:1274-1489) -------------------
    def discrete_chain_info(self, params, given=None):
        """(names, K) for the chain path: at least two discrete latents,
        all SCALAR with one shared cardinality, in topological order; None
        otherwise."""
        info = self.discrete_enum_info(params, given)
        if len(info) < 2:
            return None
        if any(tuple(shape) != () for _n, shape, _k in info):
            return None
        ks = {k for _n, _s, k in info}
        if len(ks) != 1:
            return None
        return [n for n, _s, _k in info], ks.pop()

    def discrete_chain_structure(self, given_keys=frozenset()):
        """The discrete-latent names when the structural factors form a
        pairwise Markov chain (every term touches at most two discrete
        latents, adjacent in topological order); None otherwise."""
        gk = frozenset(given_keys)
        disc = [n for n in self.discrete_latent_names if n not in gk]
        if len(disc) < 2:
            return None
        idx = {n: i for i, n in enumerate(disc)}
        for _v, deps in self._discrete_structure(gk)["terms"]:
            if len(deps) > 2:
                return None
            if len(deps) == 2:
                a, b = sorted(idx[n] for n in deps)
                if b - a != 1:
                    return None
        return disc

    def _chain_tables_structural(self, params, z, given, names, k):
        """(C, U [T, K], Psi [T-1, K, K]) from the structurally extracted
        local factors: O(T K^2) local-term evaluations."""
        given = dict(given or {})
        cards = {n: k for n in names}
        struct = self._discrete_structure(frozenset(given.keys()))
        idx = {n: i for i, n in enumerate(names)}
        store = self._as_store(params)
        ref = self._ref(self.discrete_enum_info(params, given), _given_sig(given))
        base_vals, lp_prior, lp_lik = self._walk_z(store, z, {**given, **ref})
        t_n = len(names)
        u_rows: List[list] = [[] for _ in range(t_n)]
        psi_rows: List[list] = [[] for _ in range(max(t_n - 1, 0))]
        const = lp_prior + lp_lik
        for v, deps in struct["terms"]:
            if not deps:
                continue
            dn, table = self._term_table(v, deps, struct, store, base_vals, z, cards)
            const = const - table[(0,) * len(dn)]
            if len(dn) == 1:
                u_rows[idx[dn[0]]].append(table)
            else:
                a, b = dn
                if idx[a] > idx[b]:  # axes follow the chain's order
                    table = table.T
                    a, b = b, a
                psi_rows[idx[a]].append(table)
        zero_u = torch.zeros((k,), device=self.device)
        zero_p = torch.zeros((k, k), device=self.device)
        u = torch.stack([sum(r) if r else zero_u for r in u_rows])
        psi = (torch.stack([sum(r) if r else zero_p for r in psi_rows]) if t_n > 1
               else torch.zeros((0, k, k), device=self.device))
        return const, u, psi

    def _chain_lp_vec(self, params, z, given, names):
        """lp(d) over a joint assignment d: int64 [T] of the chain."""
        def lp(d):
            g = dict(given)
            for i, n in enumerate(names):
                g[n] = d[i]
            return self.log_density_z(params, z, g)

        return lp

    def _chain_tables(self, params, z, given, names, k):
        """(base, U [T, K], Psi [T-1, K, K]) from full-density evaluations
        (T K + (T-1) K^2 + 1): with logp(d) = C + sum_t phi_t(d_{t-1}, d_t),
        second differences over adjacent pairs give the interaction,
        Psi[t] = lp(j, k) - lp(j) - lp(k) + base."""
        t_n = len(names)
        lp = self._chain_lp_vec(params, z, given, names)
        dev = self.device

        def build():
            ks = torch.arange(k, dtype=_INT, device=dev)
            unary = _rows_with_diagonal(t_n, ks)  # [T*K, T]
            pairs = torch.zeros(((t_n - 1) * k * k, t_n), dtype=_INT, device=dev)
            rows = torch.arange(pairs.shape[0], device=dev)
            tt = torch.arange(t_n - 1, device=dev).repeat_interleave(k * k)
            pairs[rows, tt] = ks.repeat_interleave(k).repeat(t_n - 1)
            pairs[rows, tt + 1] = ks.repeat((t_n - 1) * k)
            return unary, pairs

        unary, pairs = self._const_block(("chain_probe", t_n, k), build)
        base = lp(torch.zeros((t_n,), dtype=_INT, device=dev))
        u = torch.func.vmap(lp)(unary).reshape(t_n, k) - base
        pair = torch.func.vmap(lp)(pairs).reshape(t_n - 1, k, k) - base
        psi = pair - u[:-1, :, None] - u[1:, None, :]
        return base, u, psi

    def chain_enumerated_log_density(self, params, z: Dict[str, Tensor],
                                     given: Optional[Dict[str, Tensor]] = None,
                                     return_marginals: bool = False):
        """log p(z, data) with a CHAIN of interacting scalar discrete
        latents summed out by the forward algorithm over the pairwise
        tables: structural (``_chain_tables_structural``) when the factors
        form a structural chain, else from probes (``_chain_tables``,
        checked by ``check_chain_factorization``).  With
        ``return_marginals`` also ``{name: [K]}`` forward-backward
        posterior probabilities."""
        given = dict(given or {})
        ci = self.discrete_chain_info(params, given)
        if ci is None:
            raise ValueError("chain enumeration needs >=2 scalar discrete latents with "
                             "one shared cardinality")
        names, k = ci
        if self.discrete_chain_structure(frozenset(given.keys())) is not None:
            base, u, psi = self._chain_tables_structural(params, z, given, names, k)
        else:
            base, u, psi = self._chain_tables(params, z, given, names, k)
        alphas = _forward(u[0], psi, u)
        total = base + torch.logsumexp(alphas[-1], dim=-1)
        if not return_marginals:
            return total
        marg = torch.softmax(torch.stack(alphas) + torch.stack(_backward(psi, u)), dim=-1)
        return total, {n: marg[i] for i, n in enumerate(names)}

    def check_chain_factorization(self, params, given=None, atol=1e-3, trials=8) -> bool:
        """True when the discrete latents' interactions form a pairwise
        Markov chain: structurally from the DAG when it shows one, else by
        the second-difference probe at two random z with fresh random
        assignments."""
        given = dict(given or {})
        ci = self.discrete_chain_info(params, given)
        if ci is None:
            return False
        if self.discrete_chain_structure(frozenset(given.keys())) is not None:
            return True
        names, k = ci
        t_n = len(names)
        rng = np.random.RandomState(0)
        for _zdraw in range(2):
            z = self._random_z(rng)
            base, u, psi = self._chain_tables(params, z, given, names, k)
            base_f, u_f, psi_f = float(base), u.cpu().numpy(), psi.cpu().numpy()
            lp_probe = self._chain_lp_vec(params, z, given, names)
            for _ in range(max(trials // 2, 1)):
                d = rng.randint(0, k, t_n)
                pred = (base_f + u_f[np.arange(t_n), d].sum()
                        + psi_f[np.arange(t_n - 1), d[:-1], d[1:]].sum())
                actual = float(lp_probe(self._int(d).to(self.device)))
                if abs(actual - pred) > atol * max(1.0, abs(actual)):
                    return False
        return True

    # -- sequence-node enumeration (JAX compiler.py:1491-1848) -----------
    def _sequence_chain_info(self, params, given=None):
        """[(name, T, K)] when every discrete latent outside ``given`` is a
        MarkovSeries chain with a Bernoulli or Categorical transition and
        no ``log_prob_mask``; None otherwise.  Cached per ``given`` names
        and shapes."""
        from .distributions import Bernoulli, Categorical
        from .stochastic_processes import MarkovSeries

        given = given or {}
        key = _given_sig(given)
        cache = self._cache("_seq_info_cache")
        if key in cache:
            return cache[key]
        out = []
        store = self._as_store(params)
        values = None
        for n in (n for n in self.discrete_latent_names if n not in given):
            v = self._var(n)
            dist = v.distribution
            if not isinstance(dist, MarkovSeries) or getattr(v, "log_prob_mask", None) is not None:
                out = None
                break
            td = dist.transition_dist
            if isinstance(td, Bernoulli):
                k = 2
            elif isinstance(td, Categorical):
                if values is None:
                    values = self._zero_walk_values(store, given)
                _ip, tp = dist._split_params(self._params(v, values, store))
                probe = dist._transition(torch.zeros((), dtype=_INT, device=self.device), tp)
                lg = probe["logits"] if "logits" in probe else probe["probs"]
                k = int(lg.shape[-1])
            else:
                out = None
                break
            out.append((n, dist.length, k))
        result = out if out else None
        cache[key] = result
        return result

    def _sequence_chain_tables(self, v, p, t_len, k):
        """(init_lp [K], psi [T-1, K, K]) log-tables of a MarkovSeries
        chain's own prior, each from one vectorized evaluation
        (time-varying transition links vectorize over the time axis as in
        ``MarkovSeries.log_prob``); ``log_prob_scale`` folded in."""
        dist = v.distribution
        init_p, trans_p = dist._split_params(p)
        ks = torch.arange(k, dtype=_INT, device=self.device)
        init_lp = torch.func.vmap(
            lambda kv: torch.sum(dist.init_dist.log_prob(kv, **init_p)))(ks)
        prev = torch.ones((t_len - 1,), dtype=_INT, device=self.device)

        def psi_jk(j, kv):
            lp = dist.transition_dist.log_prob(prev * kv, **dist._transition(prev * j, trans_p))
            return torch.broadcast_to(lp, (t_len - 1,))

        jj, kk = self._const_block(("pairs", k), lambda: (ks.repeat_interleave(k), ks.repeat(k)))
        psi = torch.func.vmap(psi_jk)(jj, kk)  # [K*K, T-1]
        psi = psi.reshape(k, k, t_len - 1).permute(2, 0, 1)
        if v.log_prob_scale != 1.0:
            init_lp = v.log_prob_scale * init_lp
            psi = v.log_prob_scale * psi
        return init_lp, psi

    def _elementwise_term_vec(self, v2, chain_name, struct, store, base_vals, z, t_len):
        """Per-element log-prob vector [T] of ``v2``'s term as a function of
        the chain's value: the per-t columns of the forward algorithm's U."""
        fn = self._term_vec_fn(v2, struct, store, base_vals, z, (t_len,))
        return lambda d_full: fn({chain_name: d_full})

    def _term_vec_fn(self, v2, struct, store, base_vals, z, plate_shape):
        """Per-element log-prob vector of ``v2``'s term as a function of a
        {latent: full value} assignment, as ``_term_table``'s term but
        without the plate sum: the raveled [prod(plate_shape)] vector, its
        trailing event axes summed, the missing-data mask and
        ``log_prob_scale`` applied, and the log-Jacobian (unscaled) of an
        assignment-dependent support.  A term whose log-prob shape cannot
        be aligned to the plate raises ValueError."""
        needed = struct["recompute"][v2.name]
        vdeps = struct["value_deps"][v2.name]
        n_elem = math.prod(plate_shape)
        ps = tuple(plate_shape)

        def align(x):
            shp = tuple(x.shape)
            if shp == ps:
                return x.reshape(n_elem)
            if shp[:len(ps)] == ps:
                return torch.sum(x, dim=tuple(range(len(ps), len(shp)))).reshape(n_elem)
            raise ValueError(f"term {v2.name!r} has per-element shape {shp}, not "
                             f"alignable to plate {ps}")

        def term_vec(assign):
            vals = self._recompute_walk(needed, assign, base_vals, store, z)
            p = self._params(v2, vals, store)
            jac = None
            if v2.name in assign:
                value = assign[v2.name]
            elif vdeps & set(assign):
                if v2.is_observed:
                    value = self._observed_value(v2, vals, store)
                else:
                    # the z-space density needs the log-Jacobian at THIS
                    # assignment's bounds, as _term_table adds it
                    tr = transform_for(v2.distribution, p)
                    value = tr.forward(z[v2.name])
                    jac = tr.forward_log_det(z[v2.name])
            else:
                value = base_vals[v2.name]
            lp = v2.distribution.log_prob(value, **p)
            mask = getattr(v2, "log_prob_mask", None)
            if mask is not None:
                lp = lp * store.const(mask)
            if v2.log_prob_scale != 1.0:
                lp = v2.log_prob_scale * lp
            out = align(lp)
            return out if jac is None else out + align(jac)

        return term_vec

    def _state_rows(self, t_len, k) -> Tensor:
        """[K, T]: row k is the chain at state k throughout."""
        return self._const_block(("states", t_len, k), lambda: torch.arange(
            k, dtype=_INT, device=self.device)[:, None].expand(k, t_len).contiguous())

    def _sequence_setup(self, params, z, given):
        given = dict(given or {})
        info = self._sequence_chain_info(params, given)
        if not info:
            raise ValueError("sequence enumeration needs every discrete latent to be a "
                             "MarkovSeries chain with a Bernoulli/Categorical transition "
                             "family")
        struct = self._discrete_structure(frozenset(given.keys()))
        name_set = {n for n, _t, _k in info}
        for v, deps in struct["terms"]:
            if len(deps & name_set) > 1:
                raise ValueError(f"term {v.name!r} couples chains {sorted(deps)}; "
                                 "sequence enumeration handles independent chains")
        store = self._as_store(params)
        ref = self._const_block(("seq_ref", _given_sig(given)), lambda: {
            n: torch.zeros((t,), dtype=_INT, device=self.device) for n, t, _k in info})
        base_vals, lp_prior, lp_lik = self._walk_z(store, z, {**given, **ref})
        return info, struct, store, ref, base_vals, lp_prior + lp_lik

    def _sequence_emissions(self, chain_name, t_len, k, struct, store, base_vals, z):
        """(U [T, K], the reference's emission sum): each emission term
        evaluated with the chain at every state, one vmap over K a term."""
        u = torch.zeros((t_len, k), device=self.device)
        ref_sum = torch.zeros((), device=self.device)
        for v2, deps in struct["terms"]:
            if chain_name not in deps or v2.name == chain_name:
                continue
            term_vec = self._elementwise_term_vec(v2, chain_name, struct, store, base_vals, z,
                                                  t_len)
            vecs = torch.func.vmap(term_vec)(self._state_rows(t_len, k))  # [K, T]
            u = u + vecs.T
            ref_sum = ref_sum + torch.sum(vecs[0])
        return u, ref_sum

    def sequence_enumerated_log_density(self, params, z: Dict[str, Tensor],
                                        given: Optional[Dict[str, Tensor]] = None,
                                        return_marginals: bool = False):
        """log p(z, data) with MarkovSeries discrete chains summed out by the
        forward algorithm over tables built with O(K^2) vectorized
        evaluations.  Emission terms must be element-wise across the
        chain's time axis (checked by ``check_sequence_factorization``).
        With ``return_marginals`` also ``{name: [T, K]}`` forward-backward
        posterior marginals."""
        info, struct, store, ref, base_vals, total = self._sequence_setup(params, z, given)
        marginals: Dict[str, Tensor] = {}
        for chain_name, t_len, k in info:
            v = self._var(chain_name)
            p = self._params(v, base_vals, store)
            init_lp, psi = self._sequence_chain_tables(v, p, t_len, k)
            # remove the reference chain term folded into the base walk
            total = total - self._rv_log_prob(v, ref[chain_name], p, store)
            u, ref_sum = self._sequence_emissions(chain_name, t_len, k, struct, store,
                                                  base_vals, z)
            total = total - ref_sum
            alphas = _forward(init_lp + u[0], psi, u)
            total = total + torch.logsumexp(alphas[-1], dim=-1)
            if return_marginals:
                marginals[chain_name] = torch.softmax(
                    torch.stack(alphas) + torch.stack(_backward(psi, u)), dim=-1)
        if return_marginals:
            return total, marginals
        return total

    def check_sequence_factorization(self, params, given=None, atol=1e-3) -> bool:
        """The sequence decomposition checked numerically: the direct density
        at random full chain assignments must equal the table-decomposed
        value (catches emissions that couple timesteps).  Cached per
        ``given`` names."""
        return self._verdict("_seq_verdict_cache", params, given,
                             lambda p, g: self._check_sequence_factorization_impl(p, g, atol))

    def _check_sequence_factorization_impl(self, params, given, atol) -> bool:
        info = self._sequence_chain_info(params, given)
        if not info:
            return False
        rng = np.random.RandomState(0)
        for _trial in range(2):
            z = self._random_z(rng)
            d_star = {n: self._int(rng.randint(0, k, (t,))).to(self.device) for n, t, k in info}
            try:
                direct = float(self.log_density_z(params, z, {**given, **d_star}))
                decomposed = float(self._sequence_decomposed_at(params, z, given, d_star))
            except Exception:
                return False
            if abs(direct - decomposed) > atol * max(1.0, abs(direct)):
                return False
        return True

    def _sequence_decomposed_at(self, params, z, given, d_star):
        """The table-decomposed density AT a full assignment (the
        factorization probe): the same tables the enumeration uses, looked
        up at ``d_star``."""
        info, struct, store, ref, base_vals, total = self._sequence_setup(params, z, given)
        for chain_name, t_len, k in info:
            v = self._var(chain_name)
            p = self._params(v, base_vals, store)
            d = d_star[chain_name]
            total = total - self._rv_log_prob(v, ref[chain_name], p, store)
            init_lp, psi = self._sequence_chain_tables(v, p, t_len, k)
            total = total + init_lp[d[0]] + torch.sum(
                psi[torch.arange(t_len - 1, device=self.device), d[:-1], d[1:]])
            u, ref_sum = self._sequence_emissions(chain_name, t_len, k, struct, store,
                                                  base_vals, z)
            total = total - ref_sum + torch.sum(torch.gather(u, 1, d[:, None]))
        return total
