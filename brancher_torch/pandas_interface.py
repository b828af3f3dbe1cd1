"""Samples <-> pandas DataFrames.

Counterpart of ``brancher_tpu/pandas_interface.py`` (lines 16-60): a
``{variable: tensor}`` sample dict becomes a tidy DataFrame (rows = sample
index, columns = variables), and back.  Host side only; pandas is imported
inside the functions.  A tensor on the card goes to the host once, through
``.detach().cpu()``, before numpy reads it.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import default_dtype, resolve_device


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def sample_dict_to_dataframe(sample_dict: Mapping[str, Any]):
    import pandas as pd

    cols = {}
    n = None
    for name, arr in sample_dict.items():
        a = _host(arr)
        if n is None:
            n = a.shape[0] if a.ndim > 0 else 1
        if a.ndim == 0:
            cols[name] = [a.item()] * (n or 1)
        elif a.ndim == 1:
            cols[name] = list(a)
        else:
            cols[name] = [a[i] for i in range(a.shape[0])]
    return pd.DataFrame(cols)


def dataframe_to_sample_dict(df) -> Dict[str, np.ndarray]:
    out = {}
    for col in df.columns:
        vals = df[col].tolist()
        out[col] = np.stack([np.asarray(v) for v in vals])
    return out


def coerce_to_sample_dict(samples, device=None) -> Dict[str, torch.Tensor]:
    """Accept raw dicts, DataFrames, or {Variable: array} mappings: tensors
    on ``device`` (default ``config.device``)."""
    dev = resolve_device(device)
    try:
        import pandas as pd

        if isinstance(samples, pd.DataFrame):
            samples = dataframe_to_sample_dict(samples)
    except ImportError:
        pass
    return {getattr(k, "name", k): _tensor(v, dev) for k, v in samples.items()}


def _tensor(v, dev: torch.device) -> torch.Tensor:
    """A tensor on ``dev``; host floats take the default float dtype, as
    ``jnp.asarray`` gives float32 without x64."""
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    a = np.asarray(v)
    return torch.as_tensor(a, dtype=default_dtype() if a.dtype.kind in "fc" else None, device=dev)


def reformat_sample_to_pandas(sample_dict):
    """Alias kept for reference-API familiarity."""
    return sample_dict_to_dataframe(sample_dict)
