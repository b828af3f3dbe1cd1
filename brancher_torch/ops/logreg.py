"""Logistic-regression log posterior and gradient over the whole X.

Counterpart of ``brancher_tpu/ops/pallas_logreg.py``:

    val[c]  = sum_n [ y_n l_cn - softplus(l_cn) ] - |w_c|^2 / (2 sigma^2)
    grad[c] = (y - sigmoid(l_c)) @ X - w_c / sigma^2,     l_c = X @ w_c

  * ``logreg_value_and_grad_reference``: the plain PyTorch version;
  * ``logreg_value_and_grad``: kernel K6, the two-pass template of
    ``csrc/glm_vg.cu`` (no offset, no mask, prior N(0, sigma^2)), with its
    own C symbol and launch counter; a CPU tensor takes the plain version;
  * ``make_logreg_log_posterior``: a scalar-per-chain log posterior whose
    forward computes value and gradient in one K6 launch and whose
    backward returns ``g[:, None] * grad`` (the JAX ``custom_vjp``).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from ..config import resolve_device
from ..distributions import softplus

Tensor = torch.Tensor


def logreg_value_and_grad_reference(w: Tensor, x: Tensor, y: Tensor,
                                    prior_scale: float) -> Tuple[Tensor, Tensor]:
    """Plain version: w [C,d] -> (val [C], grad [C,d])."""
    logits = w @ x.T
    ll = torch.sum(y[None, :] * logits - softplus(logits), dim=-1)
    val = ll - 0.5 * torch.sum(w * w, dim=-1) / prior_scale**2
    grad = (y[None, :] - torch.sigmoid(logits)) @ x - w / prior_scale**2
    return val, grad


def _two_pass_buffers(z: Tensor, n: int, tiles: Tuple[int, int]):
    """Outputs and scratch of one K6 launch over z [C,D] and N rows:
    (val, grad, ll_part, g_part, splits, tiles_per_split).  The rows are
    cut into enough splits that (chain block, split) blocks fill the card
    twice over."""
    c, d = z.shape
    block_chains, block_rows = tiles
    n_tiles = -(-n // block_rows)
    chain_blocks = -(-c // block_chains)
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    splits = max(1, min(n_tiles, -(-2 * sms // chain_blocks)))
    tiles_per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // tiles_per_split)  # no empty split
    f32 = dict(device=z.device, dtype=torch.float32)
    return (torch.empty((c,), **f32), torch.empty((c, d), **f32),
            torch.empty((splits, c), **f32), torch.empty((splits, c, d), **f32),
            splits, tiles_per_split)


class LogregKernel:
    """Wrapper of ``logreg_vg_f32`` in ``csrc/glm_vg.cu``.  ``launches``
    counts the calls that launched it (one per value+grad evaluation)."""

    name = "logreg_f32"
    source = "brancher_torch/csrc/glm_vg.cu"
    replaces = "brancher_tpu/ops/pallas_logreg.py:45 _kernel"

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._tiles = None

    def _c_function(self):
        """The C function (``csrc/glm_vg.cu``, built and loaded at first
        use) and the template's tile sizes (chains, rows) per block."""
        if self._fn is None:
            from .cuda_build import load_library

            lib = load_library("glm_vg")
            p, i = ctypes.c_void_p, ctypes.c_int
            fn = lib.logreg_vg_f32
            fn.argtypes = [p, p, p, ctypes.c_float, p, p, p, p, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
            for tile in (lib.glm_vg_block_chains, lib.glm_vg_block_rows):
                tile.argtypes = []
                tile.restype = ctypes.c_int
            self._fn, self._tiles = fn, (lib.glm_vg_block_chains(), lib.glm_vg_block_rows())
        return self._fn

    def __call__(self, w: Tensor, x: Tensor, y: Tensor, prior_scale: float):
        if w.device.type == "cpu":
            return logreg_value_and_grad_reference(w, x, y, prior_scale)
        if w.device.type != "cuda":
            raise RuntimeError(f"{self.name} runs on CUDA tensors, got {w.device}")
        if w.dtype != torch.float32 or w.dim() != 2 or not w.is_contiguous():
            raise TypeError(f"{self.name} takes w as a contiguous [C, D] float32 tensor")
        c, d = w.shape
        n = x.shape[0]
        for nm, t, shape in (("x", x, (n, d)), ("y", y, (n,))):
            if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != w.device
                    or not t.is_contiguous()):
                raise ValueError(f"{self.name}: {nm} must be a contiguous float32 {shape} "
                                 f"tensor on {w.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
        if c == 0 or n == 0 or d == 0:
            raise ValueError(f"{self.name}: empty input (C={c}, N={n}, D={d})")
        fn = self._c_function()
        val, grad, ll_part, g_part, splits, tiles_per_split = _two_pass_buffers(w, n, self._tiles)
        with torch.cuda.device(w.device):
            stream = torch.cuda.current_stream(w.device).cuda_stream
            err = fn(w.data_ptr(), x.data_ptr(), y.data_ptr(), float(1.0 / prior_scale**2),
                     val.data_ptr(), grad.data_ptr(), ll_part.data_ptr(), g_part.data_ptr(),
                     c, n, d, splits, tiles_per_split, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        return val, grad


LOGREG = LogregKernel()


def logreg_value_and_grad(w: Tensor, x: Tensor, y: Tensor,
                          prior_scale: float = 1.0) -> Tuple[Tensor, Tensor]:
    """w [C,d] -> (val [C], grad [C,d]): K6 on CUDA tensors, the plain
    version on CPU tensors.  x [N,d] and y [N] are float32 on w's device."""
    return LOGREG(w, x, y, prior_scale)


class _LogPosterior(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, fused):
        val, grad = fused(w.detach())
        ctx.save_for_backward(grad)
        return val

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[:, None] * grad, None


def make_logreg_log_posterior(x, y, prior_scale: float = 1.0, use_pallas="auto",
                              device=None) -> Callable[[Tensor], Tensor]:
    """Batched log posterior f(w [C,d]) -> [C] whose value and gradient
    cost one K6 launch (``torch.autograd.grad`` reads the gradient the
    forward saved).

    use_pallas keeps the JAX package's name and takes only "auto": the
    kernel for CUDA tensors, the plain version for CPU tensors.  x and y
    move once to ``device`` (default: where they are when they are
    tensors, else ``config.device``).
    """
    if use_pallas != "auto":
        raise ValueError(f"use_pallas must be 'auto', got {use_pallas!r}")
    if device is None and isinstance(x, Tensor):
        device = x.device
    dev = resolve_device(device)
    xt = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
    yt = torch.as_tensor(y, dtype=torch.float32).to(dev).reshape(-1).contiguous()

    def fused(w):
        return LOGREG(w, xt, yt, prior_scale)

    def log_post(w: Tensor) -> Tensor:
        return _LogPosterior.apply(w, fused)

    return log_post


__all__ = [
    "logreg_value_and_grad_reference", "logreg_value_and_grad", "LogregKernel",
    "LOGREG", "make_logreg_log_posterior",
]
