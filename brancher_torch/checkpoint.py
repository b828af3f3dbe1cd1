"""Checkpoint and resume of inference states, on ``torch.save``.

Counterpart of ``brancher_tpu/checkpoint.py`` (lines 25-54), which writes
with orbax.  ``save_checkpoint(path, state)`` writes a tree of tensors to
the directory ``path``, as JAX does; ``restore_checkpoint(path,
template=None)`` reads it back with ``torch.load(weights_only=True)``,
which rebuilds tensors, numbers, strings and containers and nothing else.

So what ``weights_only`` refuses is written as data and rebuilt here:

  * a ``torch.Generator`` as its state and device (``get_state()``), made
    anew on restore: a sampler resumes the stream where it stopped;
  * a numpy array as a tensor, turned back into one;
  * the inference states that are not plain containers, ``StreamingState``
    and the particle methods' ``SMCRandom``, by their fields and the class's
    name, looked up on restore in a fixed table of those classes: a
    ``StreamingState`` resumes in a fresh ``StreamingSMC`` bit for bit.
    A checkpoint naming any other class is refused, so restoring one runs
    no code it names.

``template``, a tree of the same structure, casts each tensor to the
template's dtype and device (and each numpy array to its dtype).
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from .inference.smc import SMCRandom
from .inference.streaming_smc import StreamingState

_TAG = "__brancher_checkpoint__"
_FILE = "state.pt"


# the classes a checkpoint rebuilds, by name; it refuses every other
_CHECKPOINTABLE = {cls.__name__: cls for cls in (SMCRandom, StreamingState)}


def _encode(x):
    if isinstance(x, torch.Generator):
        return {_TAG: "generator", "state": x.get_state(), "device": str(x.device)}
    if isinstance(x, np.ndarray):
        return {_TAG: "numpy", "value": torch.from_numpy(np.ascontiguousarray(x))}
    if isinstance(x, np.generic):
        return x.item()
    name = type(x).__name__
    if _CHECKPOINTABLE.get(name) is type(x):
        fields = x._asdict() if isinstance(x, tuple) else vars(x)
        return {_TAG: "state", "class": name, "fields": _encode(dict(fields))}
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if type(x) in (list, tuple):
        return type(x)(_encode(e) for e in x)
    if isinstance(x, (torch.Tensor, int, float, bool, str, type(None))):
        return x
    raise TypeError(f"cannot checkpoint a {name}")


def _decode(x):
    if isinstance(x, dict) and _TAG in x:
        kind = x[_TAG]
        if kind == "generator":
            g = torch.Generator(device=x["device"])
            g.set_state(x["state"])
            return g
        if kind == "numpy":
            return x["value"].numpy()
        if kind == "state":
            cls = _CHECKPOINTABLE.get(x["class"])
            if cls is None:
                raise ValueError(f"checkpoint names the class {x['class']!r}, not one of "
                                 f"brancher_torch's checkpointable states")
            return cls(**_decode(x["fields"]))
        raise ValueError(f"unknown checkpoint entry {kind!r}")
    if isinstance(x, dict):
        return {k: _decode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_decode(e) for e in x)
    return x


def _cast(x, template):
    """``x`` with each tensor (numpy array) cast to the dtype and device
    (dtype) of the template's leaf at the same place."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(x).to(device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, dtype=template.dtype)
    if isinstance(template, torch.Generator):
        if x.device != template.device:
            g = torch.Generator(device=template.device)
            g.set_state(x.get_state())
            return g
        return x
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_cast(a, b) for a, b in zip(x, template)))
    if isinstance(template, dict):
        return {k: _cast(x[k], template[k]) for k in x}
    if isinstance(template, (list, tuple)):
        return type(x)(_cast(a, b) for a, b in zip(x, template))
    if hasattr(template, "__dict__") and hasattr(x, "__dict__") and type(x) is type(template):
        x.__dict__.update(_cast(vars(x), vars(template)))
    return x


def save_checkpoint(path: str, state: Any) -> None:
    """Save a tree of tensors (dicts, lists, tuples, numpy arrays, numbers,
    generators, ``StreamingState`` and ``SMCRandom``) to the directory
    ``path``, made if need be; an earlier checkpoint there is replaced
    whole, once the new one is written."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    with open(tmp, "wb") as f:
        torch.save(_encode(state), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, _FILE))


def restore_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    """The tree ``save_checkpoint`` wrote to ``path``.  ``template`` (a tree
    of the same structure) casts each tensor leaf to its dtype and device;
    without one each tensor comes back on the device it was saved from."""
    state = torch.load(os.path.join(os.path.abspath(path), _FILE), weights_only=True)
    state = _decode(state)
    return state if template is None else _cast(state, template)


class CheckpointableState(dict):
    """Thin dict marking inference states meant for checkpointing:

    * SVI: {"params": ..., "opt_state": ..., "step": ...}
    * MCMC: ``sample()``'s ``diagnostics["resume_state"]``
    * SMC: {"particles": ..., "log_weights": ..., "t": ...}, or a
      ``StreamingState``
    """
