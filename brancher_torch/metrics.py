"""Structured metrics and profiling hooks.

Counterpart of ``brancher_tpu/metrics.py`` (lines 18-81), under its
names: ``MetricsLogger`` writes a JSONL stream and, where
``torch.utils.tensorboard`` imports, TensorBoard scalars (an import
failure leaves ``_tb`` None, as JAX does with flax's writer);
``profile_trace`` wraps a block in ``torch.profiler`` (the CPU, plus CUDA
when a card is present) and writes a Chrome trace into ``log_dir`` in
place of ``jax.profiler``'s; ``summarize_mcmc`` tabulates an
``MCMCResult``.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _scalar(v) -> float:
    return float(v) if isinstance(v, torch.Tensor) else float(np.asarray(v))


class MetricsLogger:
    """Append-only JSONL metrics stream + optional TensorBoard."""

    def __init__(self, path: Optional[str] = None, tensorboard_dir: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                self._tb = None

    def log(self, step: int, **metrics) -> None:
        """One record: the step, the wall time and each metric as a float
        (a tensor on the card is read once, here)."""
        values = {k: _scalar(v) for k, v in metrics.items()}
        rec = {"step": int(step), "time": time.time(), **values}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb:
            for k, v in values.items():
                self._tb.add_scalar(k, v, int(step))

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Profile a block with ``torch.profiler`` and write its Chrome trace
    (Perfetto opens it) to ``log_dir/trace.json``; yields ``log_dir``
    (default ``brancher_torch_trace`` under the temporary directory)::

        with profile_trace("trace_dir"):
            sample(model, ...)

    CUDA activities are recorded when a card is present; the block's
    pending card work is waited for before the trace ends."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "brancher_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def summarize_mcmc(result) -> Dict[str, Any]:
    """One entry per variable: mean, sd and, where ``sample()`` computed
    them, ESS and R-hat (numpy)."""
    out = {}
    for name, s in result.samples.items():
        arr = s.detach().cpu().numpy() if isinstance(s, torch.Tensor) else np.asarray(s)
        flat = arr.reshape(arr.shape[0] * arr.shape[1], -1)
        entry = {"mean": flat.mean(0), "sd": flat.std(0)}
        if name in result.diagnostics.get("ess", {}):
            entry["ess"] = np.asarray(result.diagnostics["ess"][name])
            entry["r_hat"] = np.asarray(result.diagnostics["r_hat"][name])
        out[name] = entry
    return out
