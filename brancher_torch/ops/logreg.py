"""Logistic-regression log posterior and gradient over the whole X.

Counterpart of ``brancher_tpu/ops/pallas_logreg.py``:

    val[c]  = sum_n [ y_n l_cn - softplus(l_cn) ] - |w_c|^2 / (2 sigma^2)
    grad[c] = (y - sigmoid(l_c)) @ X - w_c / sigma^2,     l_c = X @ w_c

  * ``logreg_value_and_grad_reference``: the plain PyTorch version;
  * ``logreg_value_and_grad``: kernel K6 on CUDA tensors, the plain version
    on CPU tensors.  K6 is the Bernoulli GLM with b = 0, m = 0, iv =
    1/sigma^2 on every coordinate and ll_scale = 1 (``logreg_data``), run
    on K1's f32 passes (``csrc/glm_sm90.cuh``) under its own C symbol
    ``logreg_vg_f32`` and launch counter (``LOGREG``, a ``GlmKernel``);
  * ``make_logreg_log_posterior``: a scalar-per-chain log posterior whose
    forward computes value and gradient in one K6 launch and whose
    backward returns ``g[:, None] * grad`` (the JAX ``custom_vjp``).
"""
from __future__ import annotations

import weakref
from typing import Callable, Tuple

import torch

from ..config import resolve_device
from ..distributions import softplus
from .glm import FusedFamily, GlmKernel, build_glm_data

Tensor = torch.Tensor


def logreg_value_and_grad_reference(w: Tensor, x: Tensor, y: Tensor,
                                    prior_scale: float) -> Tuple[Tensor, Tensor]:
    """Plain version: w [C,d] -> (val [C], grad [C,d])."""
    logits = w @ x.T
    ll = torch.sum(y[None, :] * logits - softplus(logits), dim=-1)
    val = ll - 0.5 * torch.sum(w * w, dim=-1) / prior_scale**2
    grad = (y[None, :] - torch.sigmoid(logits)) @ x - w / prior_scale**2
    return val, grad


def logreg_data(x: Tensor, y: Tensor, prior_scale: float) -> FusedFamily:
    """The Bernoulli ``FusedFamily`` K6 runs over, on x's device: X and y as
    given (X with the row layout of ``build_glm_data``, a copy only where
    D's rows are not 128 bytes), b = 0, prior mean 0 and inverse variance
    1/sigma^2 on every coordinate, ll_scale 1.  Its ``plain`` is K6's
    function."""
    n, d = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    return build_glm_data("bernoulli_logit", x, y, torch.zeros(n, **f32), torch.zeros(d, **f32),
                          torch.full((d,), 1.0 / prior_scale**2, **f32), device=x.device)


LOGREG = GlmKernel("logreg_f32", "bernoulli_logit", torch.float32, "logreg_vg_f32",
                   "brancher_tpu/ops/pallas_logreg.py:45 _kernel")


def _tensor_key(t: Tensor) -> tuple:
    # _version moves with every edit in place, so an edited X is rebuilt
    return (t.data_ptr(), t._version, tuple(t.shape), t.stride(), t.dtype)


def _detached(t: Tensor, src: Tensor) -> Tensor:
    # another tensor object over the same memory: holding it does not hold src
    return t.detach() if t is src else t


class _LastData:
    """The data of the last (x, y, sigma, device) ``logreg_value_and_grad``
    served.  A caller passes the same x and y on every call; building the
    three small vectors anew would add launches to a call that is launch-
    bound at the floor shape.

    The entry dies with x or y: it holds them only through weak references
    (the family keeps other tensor objects over their memory, never x or y
    themselves), and a reference's callback drops the entry, its scratch
    and any aligned copy of X, once the caller's x or y is collected.  While
    both live, their memory cannot pass to another tensor."""

    __slots__ = ("key", "refs", "data")

    def __init__(self):
        self.key = self.refs = self.data = None

    def _drop(self, ref) -> None:
        if self.refs is not None and any(r is ref for r in self.refs):
            self.key = self.refs = self.data = None

    def _alive(self, x: Tensor, y: Tensor) -> bool:
        return self.refs is not None and self.refs[0]() is x and self.refs[1]() is y

    def get(self, x: Tensor, y: Tensor, prior_scale: float) -> FusedFamily:
        key = (x.device, float(prior_scale), _tensor_key(x), _tensor_key(y))
        if self.key != key or not self._alive(x, y):
            data = logreg_data(x, y, prior_scale)
            self.data = data._replace(x=_detached(data.x, x), y=_detached(data.y, y))
            self.refs = (weakref.ref(x, self._drop), weakref.ref(y, self._drop))
            self.key = key
        return self.data


_LAST = _LastData()


def logreg_value_and_grad(w: Tensor, x: Tensor, y: Tensor,
                          prior_scale: float = 1.0) -> Tuple[Tensor, Tensor]:
    """w [C,d] -> (val [C], grad [C,d]): K6 on CUDA tensors, the plain
    version on CPU tensors.  x [N,d] and y [N] are float32 on w's device."""
    if w.device.type == "cpu":
        return logreg_value_and_grad_reference(w, x, y, prior_scale)
    if w.device.type != "cuda":
        raise RuntimeError(f"{LOGREG.name} runs on CUDA tensors, got {w.device}")
    n = x.shape[0]
    for nm, t, shape in (("x", x, (n, w.shape[-1])), ("y", y, (n,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != w.device:
            raise ValueError(f"{LOGREG.name}: {nm} must be a float32 {shape} tensor on "
                             f"{w.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    return LOGREG(w, _LAST.get(x, y, prior_scale))


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
    tensors, else ``config.device``), and K6's data is built once there.
    """
    if use_pallas != "auto":
        raise ValueError(f"use_pallas must be 'auto', got {use_pallas!r}")
    if device is None and isinstance(x, Tensor):
        device = x.device
    dev = resolve_device(device)
    xt = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
    yt = torch.as_tensor(y, dtype=torch.float32).to(dev).reshape(-1).contiguous()
    if dev.type == "cpu":
        def fused(w):
            return logreg_value_and_grad_reference(w, xt, yt, prior_scale)
    else:
        data = logreg_data(xt, yt, prior_scale)

        def fused(w):
            return LOGREG(w, data)

    def log_post(w: Tensor) -> Tensor:
        return _LogPosterior.apply(w, fused)

    return log_post


__all__ = [
    "logreg_value_and_grad_reference", "logreg_value_and_grad", "logreg_data",
    "LOGREG", "make_logreg_log_posterior",
]
