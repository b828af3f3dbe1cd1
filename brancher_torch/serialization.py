"""Model serialization: a full round trip, and an inspectable spec.

Counterpart of ``brancher_tpu/serialization.py`` (lines 28-275), under its
names:

  * ``save_model`` / ``load_model`` — the whole model (DAG, closures,
    observations) through cloudpickle, imported when called.  The compiled
    models (and their device copies of the data) are left out and rebuilt
    on first use.
  * ``model_spec`` — a JSON-able structural description (name →
    distribution / parents / observed / shapes); with
    ``include_links=True`` it holds enough (constants, direct links,
    observed data, the distributions' constructor state) for
    ``build_model`` to rebuild the model.  ``save_spec`` writes it and
    ``spec_matches`` compares a live model with one.

The spec itself holds no device.  It is the JAX package's, key for key, so
a spec written by either package builds in the other.  ``model_spec``
compiles the model to read its shapes, so it takes ``device=`` (default
``config.device``), as the entry points do; a tensor on the card goes
through ``.cpu()`` before ``tolist()``.

A model pickled with tensors on the card holds CUDA storage.
``load_model(path, device=None)`` puts every such tensor, and the observed
data, on ``resolve_device(device)``: it raises without CUDA when that is
the card, and never falls back to the CPU.  Trained parameters are
separate, as in JAX: save them with ``brancher_torch.checkpoint``.
"""
from __future__ import annotations

import contextlib
import json
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import resolve_device
from .variables import DeterministicVariable, ParamStore, ProbabilisticModel, RandomVariable

def _on_load_device(t: torch.Tensor) -> torch.Tensor:
    """The host copy of a tensor pickled from the card; ``load_model``'s
    unpickler moves it to its device instead."""
    return t


def _pickler(f):
    import cloudpickle

    class _Pickler(cloudpickle.CloudPickler):
        def reducer_override(self, obj):
            if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
                return _on_load_device, (obj.detach().cpu(),)
            return super().reducer_override(obj)

    return _Pickler(f)


class _Unpickler(pickle.Unpickler):
    """Puts the tensors pickled from the card on ``device``."""

    def __init__(self, f, device: torch.device):
        super().__init__(f)
        self.device = device

    def find_class(self, module, name):
        if (module, name) == (__name__, "_on_load_device"):
            return lambda t: t.to(self.device)
        return super().find_class(module, name)


def save_model(model: ProbabilisticModel, path: str) -> None:
    """Serialize the full model (DAG, closures, observations) to a file."""
    caches = model._compiled_cache
    model._compiled_cache = {}
    try:
        with open(path, "wb") as f:
            _pickler(f).dump(model)
    finally:
        model._compiled_cache = caches


def load_model(path: str, device=None) -> ProbabilisticModel:
    """A model written by ``save_model``, its tensors that were on the card
    and its observed data on ``device`` (default ``config.device``).  Load
    only files this program wrote: unpickling runs code."""
    import cloudpickle  # noqa: F401  (what the pickle's functions are rebuilt by)

    dev = resolve_device(device)
    with open(path, "rb") as f:
        model = _Unpickler(f, dev).load()
    for v in model.variables:
        if isinstance(v._observed, torch.Tensor):
            v._observed = v._observed.to(dev)
    model._compiled_cache = {}  # compiled models rebuild on first use
    return model


def _host_const(t) -> Dict[str, Any]:
    arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return {"kind": "const", "value": arr.tolist(), "dtype": str(arr.dtype)}


def model_spec(model: ProbabilisticModel, include_links: bool = False,
               device=None) -> Dict[str, Any]:
    """JSON-able structural description of the DAG.

    With ``include_links=True`` the spec also holds, per parameter link,
    the constant, the parent it reads, or an ``opaque`` marker (expression
    closures are not JSON-able), plus observed data and each
    distribution's constructor state: enough for :func:`build_model` to
    rebuild the model whenever no link is opaque."""
    comp = model.compiled(device)
    out: Dict[str, Any] = {"variables": []}
    for v in comp.order:
        entry: Dict[str, Any] = {
            "name": v.name,
            "parents": [p.name for p in v.parents],
            "observed": bool(v.is_observed),
        }
        if isinstance(v, RandomVariable):
            entry["kind"] = "random"
            entry["distribution"] = type(v.distribution).__name__
            entry["params"] = sorted(v.links.keys())
            entry["plate_shape"] = list(v.plate_shape)
            entry["log_prob_scale"] = float(v.log_prob_scale)
            if include_links:
                entry["links"] = {k: _serialize_link(v.links[k]) for k in sorted(v.links)}
                entry["distribution_state"] = _serialize_dist(v.distribution)
                if v.is_observed:
                    if isinstance(v._observed, torch.Tensor):
                        entry["observed_value"] = _host_const(v._observed)
                    else:
                        entry["observed_value"] = {"kind": "opaque"}
        elif isinstance(v, DeterministicVariable):
            entry["kind"] = "deterministic"
            entry["learnable"] = bool(v.learnable)
            if include_links:
                if v.link is not None:
                    entry["link"] = _serialize_link(v.link)
                else:
                    entry["value"] = _host_const(v.value)
        entry["shape"] = list(comp.shapes.get(v.name, ()))
        out["variables"].append(entry)
    out["latents"] = list(comp.latent_names)
    out["observed"] = list(comp.observed_names)
    return out


def _serialize_link(link) -> Dict[str, Any]:
    """Classify a PartialLink as const / single-variable / opaque."""
    if not link.vars:
        return _host_const(link.fn({}, ParamStore(device=torch.device("cpu"))))
    if len(link.vars) == 1:
        # identity detection: a pure values[name] lookup returns the
        # sentinel unchanged; any arithmetic on it raises
        sentinel = object()
        with contextlib.suppress(Exception):
            if link.fn({link.vars[0].name: sentinel}, None) is sentinel:
                return {"kind": "var", "name": link.vars[0].name}
    return {"kind": "opaque", "vars": [v.name for v in link.vars]}


def _serialize_dist(dist) -> Optional[Dict[str, Any]]:
    """A Distribution's constructor state when it is JSON-able (scalars,
    tuples and dicts of scalars, nested Distributions); None when it holds
    closures or tensors (a MarkovSeries' transition_fn)."""
    from .distributions import Distribution

    state: Dict[str, Any] = {}
    for k, v in vars(dist).items():
        if isinstance(v, Distribution):
            sub = _serialize_dist(v)
            if sub is None:
                return None
            state[k] = {"__dist__": sub}
        elif isinstance(v, (int, float, bool, str)) or v is None:
            state[k] = v
        elif isinstance(v, (tuple, list)) and all(isinstance(e, (int, float, bool, str)) for e in v):
            state[k] = {"__tuple__": list(v)}
        elif isinstance(v, dict) and all(isinstance(e, (int, float, bool, str)) for e in v.values()):
            state[k] = {"__dict__": dict(v)}
        else:
            return None
    return {"class": type(dist).__name__, "state": state}


def _dist_registry() -> Dict[str, type]:
    """Every Distribution class of ``distributions`` and
    ``stochastic_processes`` by name: JAX's names."""
    import inspect

    from . import distributions as dist_mod
    from . import stochastic_processes as sp_mod
    from .distributions import Distribution

    reg: Dict[str, type] = {}
    for mod in (dist_mod, sp_mod):
        for nm, obj in vars(mod).items():
            if inspect.isclass(obj) and issubclass(obj, Distribution):
                reg[nm] = obj
    return reg


def _rebuild_dist(ser: Dict[str, Any]):
    cls = _dist_registry().get(ser["class"])
    if cls is None:
        raise ValueError(f"unknown distribution class {ser['class']!r}")
    obj = cls.__new__(cls)
    for k, v in ser["state"].items():
        if isinstance(v, dict) and "__dist__" in v:
            setattr(obj, k, _rebuild_dist(v["__dist__"]))
        elif isinstance(v, dict) and "__tuple__" in v:
            setattr(obj, k, tuple(v["__tuple__"]))
        elif isinstance(v, dict) and "__dict__" in v:
            setattr(obj, k, dict(v["__dict__"]))
        else:
            setattr(obj, k, v)
    return obj


def _decode_const(ser: Dict[str, Any]) -> np.ndarray:
    return np.asarray(ser["value"], dtype=np.dtype(ser["dtype"]))


def build_model(spec: Dict[str, Any]) -> ProbabilisticModel:
    """Rebuild a ProbabilisticModel from ``model_spec(model,
    include_links=True)``: constant or direct-variable links, leaf or
    variable-valued deterministic nodes, distributions whose constructor
    state is JSON-able.  Expression links (``opaque``) and data-loader
    observations raise a ValueError naming the offender; such models
    round-trip through :func:`save_model` instead.  The model holds no
    device until it is compiled."""
    built: Dict[str, Any] = {}
    for entry in spec["variables"]:
        name = entry["name"]
        if entry["kind"] == "deterministic":
            if "value" in entry:
                var = DeterministicVariable(_decode_const(entry["value"]), name=name,
                                            learnable=entry.get("learnable", False))
            elif "link" in entry and entry["link"]["kind"] == "var":
                var = DeterministicVariable(built[entry["link"]["name"]], name=name)
            else:
                raise ValueError(
                    f"deterministic variable {name!r} has an opaque expression link; "
                    "use save_model/load_model for this model")
        elif entry["kind"] == "random":
            if "links" not in entry:
                raise ValueError("spec lacks link data — produce it with "
                                 "model_spec(model, include_links=True)")
            if entry.get("distribution_state") is None:
                raise ValueError(
                    f"distribution of {name!r} ({entry['distribution']}) holds "
                    "non-serializable state (closures); use save_model/load_model "
                    "for this model")
            links = {}
            for pname, ser in entry["links"].items():
                if ser["kind"] == "const":
                    links[pname] = _decode_const(ser)
                elif ser["kind"] == "var":
                    links[pname] = built[ser["name"]]
                else:
                    raise ValueError(f"link {name}.{pname} is an opaque expression; "
                                     "use save_model/load_model for this model")
            var = RandomVariable(_rebuild_dist(entry["distribution_state"]), name=name,
                                 links=links, plate_shape=tuple(entry["plate_shape"]),
                                 log_prob_scale=entry["log_prob_scale"])
            if entry["observed"]:
                obs = entry.get("observed_value")
                if obs is None or obs["kind"] != "const":
                    raise ValueError(f"observed variable {name!r} has a non-constant "
                                     "observation (data loader); use save_model/load_model")
                var.observe(_decode_const(obs))
        else:
            raise ValueError(f"unknown variable kind {entry['kind']!r}")
        built[name] = var
    return ProbabilisticModel(list(built.values()))


def save_spec(model: ProbabilisticModel, path: str, device=None) -> None:
    with open(path, "w") as f:
        json.dump(model_spec(model, device=device), f, indent=2, sort_keys=True)


def spec_matches(model: ProbabilisticModel, spec: Dict[str, Any], device=None) -> bool:
    """True iff the live model's structure equals the stored spec."""
    return json.dumps(model_spec(model, device=device), sort_keys=True) == json.dumps(
        spec, sort_keys=True)
