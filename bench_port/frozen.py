"""Frozen copies of the arithmetic the benchmark measures with.

Later changes to the program cannot move these: each function is copied
from the file named in its docstring and imports nothing of the program.
"""
from __future__ import annotations

import math
import statistics
import time

# published H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s and
# operations/s by operand type (f32 on the CUDA cores, bf16 on the tensor
# cores), as chip_smoke.py has them.  A card set below 700 W reaches less;
# the run prints its power limit beside every share of these.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12}


def effective_sample_size(samples) -> "torch.Tensor":
    """ESS of [chains, draws, ...] samples (per column, in float64, where
    they are), capped at chains * draws.  The arithmetic of
    ``brancher_torch/inference/diagnostics.py`` (``_autocovariance_fft`` and
    ``effective_sample_size``, numpy there), copied into torch: Geyer's
    initial monotone sequence on the FFT autocovariance, BDA3's
    between-chain term."""
    import torch

    x = torch.as_tensor(samples).to(torch.float64)
    chains, draws = x.shape[0], x.shape[1]
    if draws < 2:
        return torch.full(x.shape[2:], math.nan, dtype=torch.float64)
    flat = x.reshape(chains, draws, -1)
    xc = flat - flat.mean(1, keepdim=True)
    n_fft = int(2 ** math.ceil(math.log2(2 * draws)))
    f = torch.fft.rfft(xc, n=n_fft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=n_fft, dim=1)[:, :draws] / draws
    mean_acov = acov.mean(0)
    w = acov[:, 0].mean(0) * draws / (draws - 1.0)
    b_over_n = flat.mean(1).var(0) if chains > 1 else torch.zeros_like(w)
    var_plus = w * (draws - 1.0) / draws + b_over_n
    rho = 1.0 - (w[None, :] - mean_acov) / var_plus[None, :]
    rho[0] = 1.0
    t_half = draws // 2
    p = rho[0:2 * t_half:2] + rho[1:2 * t_half:2]
    p = p * torch.cumprod((p > 0.0).to(p.dtype), 0)
    p = torch.clamp(torch.cummin(p, 0).values, min=0.0)
    tau = torch.clamp(-1.0 + 2.0 * p.sum(0), min=1.0 / math.log10(float(draws * chains)))
    ess = torch.clamp(chains * draws / tau, max=float(chains * draws))
    return ess.reshape(x.shape[2:])


def potential_scale_reduction(samples) -> "torch.Tensor":
    """Split R-hat of [chains, draws, ...] samples (in float64, where they
    are).  The arithmetic of ``brancher_torch/inference/diagnostics.py``
    (``potential_scale_reduction``, numpy there), copied into torch."""
    import torch

    x = torch.as_tensor(samples).to(torch.float64)
    draws = x.shape[1]
    if draws < 4:
        return torch.full(x.shape[2:], math.nan, dtype=torch.float64)
    half = draws // 2
    split = torch.cat([x[:, :half], x[:, half:2 * half]], 0)
    n = split.shape[1]
    flat = split.reshape(split.shape[0], n, -1)
    w = flat.var(1).mean(0)
    b = n * flat.mean(1).var(0)
    rhat = torch.sqrt(((n - 1.0) / n * w + b / n) / w)
    return rhat.reshape(x.shape[2:])


def time_ms(fn, reps: int = 11, warm_ms: float = 50.0) -> float:
    """Median ms of ``reps`` launches enqueued back to back, each between two
    CUDA events, after at least ``warm_ms`` of synchronised calls.  Copied
    from ``chip_smoke.py`` (``time_ms``)."""
    import torch

    t0 = time.perf_counter()
    for i in range(10**6):
        fn()
        torch.cuda.synchronize()
        if i >= 1 and (time.perf_counter() - t0) * 1e3 >= warm_ms:
            break
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def bound(nbytes: float, flops: float, dtype: str = "f32") -> dict:
    """The least time of a call, from its bytes and operations at the
    published peaks.  Copied from ``chip_smoke.py`` (``_bound``)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_OPS[dtype] * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def make_logreg_data(num_points: int, dim: int, seed: int, device, intercept: bool = True):
    """x [N, D] iid N(0, 1), w_true ~ N(0, 1/D), y ~ Bernoulli(sigmoid(x w_true)):
    the recipe of ``brancher_torch/models/logistic_regression.py``
    (``make_logreg_data``), drawn on ``device`` from a torch.Generator in a
    few large calls, with column 0 set to 1 (the intercept) when asked."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed))
    w_true = torch.randn(dim, generator=g, device=device) / math.sqrt(dim)
    x = torch.randn(num_points, dim, generator=g, device=device)
    if intercept:
        x[:, 0] = 1.0
    logits = x @ w_true
    y = (torch.rand(num_points, generator=g, device=device) < torch.sigmoid(logits)).to(torch.int32)
    return x, y, w_true
