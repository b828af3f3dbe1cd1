"""Carry state from the JAX package into the port.

The JAX package's state arrives as numpy arrays (``np.asarray`` of its
jax arrays); these functions turn it into the port's state on a chosen
device, so that both packages compute the same function in the parity
tests: the ``params`` dict of a compiled model (flax module variables
included, as the port's module params; a flow's learnable leaves, which
are plain entries ``{name}__flow{i}_{param}``), SVI results (WVGD/SVGD's
``particles_z`` too), the fields of a ``FusedFamily`` or a
``CategoricalFusedFamily``, flat ``z`` batches and step-size /
inverse-mass arrays.  Nothing here
imports JAX or ``brancher_tpu``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import resolve_device


def to_tensor(array: Any, device=None, dtype=torch.float32) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor of ``dtype`` on ``device``;
    ``dtype=None`` keeps the array's own dtype."""
    t = torch.from_numpy(np.array(array))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def _is_flax_variables(tree) -> bool:
    return isinstance(tree, Mapping) and set(tree) == {"params"} and isinstance(tree["params"], Mapping)


def flax_to_module_params(variables: Mapping[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """A flax module's variables ``{"params": {"Dense_0": {"kernel", "bias"},
    ...}}`` (as numpy) as the params of the port's module with the same
    layer names (``functional_call`` keys ``"Dense_0.weight"``, ...): a 2-D
    ``kernel`` [in, out] becomes ``weight`` [out, in]."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            elif k == "kernel" and np.ndim(v) == 2:
                out[f"{prefix}weight"] = to_tensor(np.asarray(v).T, device, dtype=None)
            else:
                out[f"{prefix}{k}"] = to_tensor(v, device, dtype=None)

    walk(variables["params"], "")
    return out


def params_to_torch(params: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """A params dict (possibly nested; e.g. a compiled model's params, or
    SVI's {"p": ..., "q": ...}) on ``device``; flax module variables in it
    become the port's module params (``flax_to_module_params``)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if _is_flax_variables(v):
            out[k] = flax_to_module_params(v, device)
        elif isinstance(v, Mapping):
            out[k] = params_to_torch(v, device)
        else:
            out[k] = to_tensor(v, device, dtype=None)
    return out


FUSED_FIELDS = ("family", "x", "y", "b", "u", "c0", "prior_mean", "prior_inv_var", "ll_scale")
CATEGORICAL_FIELDS = ("x", "y_onehot", "c", "cols", "ks", "prior_mean", "prior_inv_var",
                      "ll_scale")


def fused_family_from_numpy(fields: Mapping[str, Any], device=None):
    """A port ``FusedFamily`` from the fields of a JAX one
    (``{name: np.asarray(getattr(fam, name))}``), or a
    ``CategoricalFusedFamily`` from a JAX one's (``CATEGORICAL_FIELDS``;
    its ``cols`` and ``ks`` become int64 index tensors)."""
    from .ops.glm import CategoricalFusedFamily, FusedFamily

    dev = resolve_device(device)
    if "cols" in fields:
        return CategoricalFusedFamily(
            x=to_tensor(fields["x"], dev).contiguous(),
            y_onehot=to_tensor(fields["y_onehot"], dev).contiguous(),
            c=to_tensor(fields["c"], dev).contiguous(),
            cols=to_tensor(fields["cols"], dev, dtype=torch.int64).reshape(-1),
            ks=to_tensor(fields["ks"], dev, dtype=torch.int64).reshape(-1),
            prior_mean=to_tensor(fields["prior_mean"], dev).reshape(-1),
            prior_inv_var=to_tensor(fields["prior_inv_var"], dev).reshape(-1),
            ll_scale=float(fields["ll_scale"]),
        )
    u = fields.get("u")
    return FusedFamily(
        family=str(fields["family"]),
        x=to_tensor(fields["x"], dev).contiguous(),
        y=to_tensor(fields["y"], dev).reshape(-1),
        b=to_tensor(fields["b"], dev).reshape(-1),
        u=None if u is None else to_tensor(u, dev).reshape(-1),
        c0=float(fields["c0"]),
        prior_mean=to_tensor(fields["prior_mean"], dev).reshape(-1),
        prior_inv_var=to_tensor(fields["prior_inv_var"], dev).reshape(-1),
        ll_scale=float(fields["ll_scale"]),
    )


def sampler_state_to_torch(state: Mapping[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """Flat ``z`` batches, step sizes and inverse masses as float32 tensors."""
    return {k: to_tensor(v, device) for k, v in state.items()}
