"""Posterior and diagnostic plots.

Counterpart of ``brancher_tpu/visualizations.py`` (lines 15-137), under
its names: ``plot_posterior``, ``plot_density`` (seaborn's KDE),
``ensemble_histogram`` and ``plot_loss_curve``, on matplotlib imported when
called (the Agg backend unless one is set).  Host side only; they accept
sample DataFrames, sample dicts (tensors on the card go to the host once)
or an ``MCMCResult``, through its ``to_pandas``.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np


def _to_frame(samples):
    import pandas as pd

    if isinstance(samples, pd.DataFrame):
        return samples
    if hasattr(samples, "to_pandas"):  # MCMCResult
        return samples.to_pandas()
    from .pandas_interface import sample_dict_to_dataframe

    return sample_dict_to_dataframe(samples)


def _flat_columns(df, variables: Optional[Sequence[str]] = None):
    cols = list(variables) if variables else list(df.columns)
    out = {}
    for c in cols:
        vals = np.stack([np.atleast_1d(np.asarray(v)) for v in df[c]])
        flat = vals.reshape(vals.shape[0], -1)
        if flat.shape[1] == 1:
            out[c] = flat[:, 0]
        else:
            for j in range(flat.shape[1]):
                out[f"{c}[{j}]"] = flat[:, j]
    return out


def plot_posterior(samples, variables: Optional[Sequence[str]] = None, ax=None,
                   bins: int = 40, show: bool = False):
    """Histogram grid of posterior marginals (reference API)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    df = _to_frame(samples)
    cols = _flat_columns(df, variables)
    n = len(cols)
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 2.5), squeeze=False)
    for axi, (name, vals) in zip(axes[0], cols.items()):
        axi.hist(vals, bins=bins, density=True, alpha=0.75)
        axi.set_title(name)
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def plot_density(samples, variables: Optional[Sequence[str]] = None, ax=None,
                 show: bool = False):
    """KDE plot of one or two marginals (reference API)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    import seaborn as sns

    df = _to_frame(samples)
    cols = _flat_columns(df, variables)
    names = list(cols)
    if ax is None:
        fig, ax = plt.subplots(figsize=(4, 3))
    else:
        fig = ax.figure
    if len(names) >= 2:
        sns.kdeplot(x=cols[names[0]], y=cols[names[1]], ax=ax, fill=True)
        ax.set_xlabel(names[0])
        ax.set_ylabel(names[1])
    else:
        sns.kdeplot(x=cols[names[0]], ax=ax, fill=True)
        ax.set_xlabel(names[0])
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def ensemble_histogram(sample_list: Iterable, variable: str, bins: int = 40,
                       labels: Optional[Sequence[str]] = None, show: bool = False):
    """Overlayed histograms of one variable across several sample sets
    (reference API)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 3))
    for i, samples in enumerate(sample_list):
        df = _to_frame(samples)
        cols = _flat_columns(df, [variable])
        vals = next(iter(cols.values()))
        label = labels[i] if labels else f"set {i}"
        ax.hist(vals, bins=bins, density=True, alpha=0.5, label=label)
    ax.set_xlabel(variable)
    ax.legend()
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def plot_loss_curve(model_or_result, ax=None, show: bool = False):
    """Plot the training loss curve recorded by perform_inference."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    curve = (
        model_or_result.diagnostics["loss curve"]
        if hasattr(model_or_result, "diagnostics")
        else model_or_result.loss_curve
    )
    if ax is None:
        fig, ax = plt.subplots(figsize=(4, 3))
    else:
        fig = ax.figure
    ax.plot(np.asarray(curve))
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    fig.tight_layout()
    if show:
        plt.show()
    return fig
