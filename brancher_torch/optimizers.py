"""Optimizers over a model's parameter tree.

Counterpart of ``brancher_tpu/optimizers.py`` (``ProbabilisticOptimizer``)
and of the optax rules that ``perform_inference`` resolves by name
(``brancher_tpu/inference/svi.py:37-54``).  Parameters are nested dicts of
tensors (a compiled model's ``initial_params``; SVI's {"p", "q", "z"});
``trainable_copy`` gives a copy whose floating leaves require grad and
are the tensors a ``torch.optim`` optimizer steps in place.

Where ``torch.optim``'s rule differs from optax's, the rule is written
here: ``OptaxRMSProp`` (optax decays by 0.9 with eps inside the square
root; torch's RMSprop by 0.99 with eps outside) and ``OptaxAdagrad``
(optax starts its sum at 0.1 with eps 1e-7 inside the root; torch at 0
with 1e-10 outside).  ``adam`` and ``sgd`` agree, and ``adamw`` does with
optax's weight decay of 1e-4 (torch's default is 1e-2).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import torch

Tensor = torch.Tensor


def trainable_copy(tree) -> Tuple[Any, List[Tensor]]:
    """A copy of a nested dict of tensors, and its floating leaves, which
    require grad (the tensors an optimizer steps)."""
    leaves: List[Tensor] = []

    def copy(t):
        if isinstance(t, Mapping):
            return {k: copy(v) for k, v in t.items()}
        t = torch.as_tensor(t).detach().clone()
        if t.is_floating_point():
            leaves.append(t.requires_grad_(True))
        return t

    return copy(tree), leaves


def detached(tree):
    """The nested dict with every leaf detached from autograd."""
    if isinstance(tree, Mapping):
        return {k: detached(v) for k, v in tree.items()}
    return tree.detach()


def set_grads(loss: Tensor, leaves: List[Tensor]) -> None:
    """Each leaf's ``.grad`` = d loss / d leaf, zeros for a leaf the loss
    does not reach (as optax sees it, so that weight decay still runs)."""
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True) if leaves else ()
    for p, g in zip(leaves, grads):
        p.grad = g


class OptaxRMSProp(torch.optim.Optimizer):
    """optax.rmsprop: nu = (1 - decay) g^2 + decay nu;
    p -= lr g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, initial_scale=initial_scale))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.full_like(p, group["initial_scale"])
                g = p.grad
                nu = (1.0 - group["decay"]) * (g * g) + group["decay"] * state["nu"]
                state["nu"] = nu
                p.add_(torch.rsqrt(nu + group["eps"]) * g * -group["lr"])


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad: s = g^2 + s (s starts at 0.1);
    p -= lr g / sqrt(s + eps) where s > 0."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                g = p.grad
                s = g * g + state["sum"]
                state["sum"] = s
                inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
                p.add_(inv * g * -group["lr"])


_BY_NAME: Dict[str, Callable] = {
    "adam": lambda ps, lr: torch.optim.Adam(ps, lr=lr),
    "adamw": lambda ps, lr: torch.optim.AdamW(ps, lr=lr, weight_decay=1e-4),
    "sgd": lambda ps, lr: torch.optim.SGD(ps, lr=lr),
    "rmsprop": lambda ps, lr: OptaxRMSProp(ps, lr),
    "adagrad": lambda ps, lr: OptaxAdagrad(ps, lr),
}


def resolve_optimizer(optimizer, lr: float) -> Callable[[List[Tensor]], torch.optim.Optimizer]:
    """A factory params -> optimizer: a name ("adam", "adamw", "sgd",
    "rmsprop", "adagrad", each with optax's update rule), a
    ``torch.optim.Optimizer`` class (made with ``lr=lr``), or a callable
    that makes the optimizer from the params itself."""
    if isinstance(optimizer, str):
        name = optimizer.lower()
        if name not in _BY_NAME:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        return lambda params: _BY_NAME[name](params, lr)
    if isinstance(optimizer, type) and issubclass(optimizer, torch.optim.Optimizer):
        return lambda params: optimizer(params, lr=lr)
    if callable(optimizer):
        return optimizer
    raise TypeError(f"optimizer must be a name, an Optimizer class or a factory, got {optimizer!r}")


class ProbabilisticOptimizer:
    """Gathers a model's learnable params and steps them with a torch
    optimizer.

    Example::

        opt = ProbabilisticOptimizer(model, "adam", lr=1e-2, device="cpu")
        loss, params = opt.step(lambda params: my_loss(params))
    """

    def __init__(self, model, optimizer: Any = "adam", lr: float = 0.01, device=None):
        self.model = model
        self.params, self._leaves = trainable_copy(model.compiled(device).initial_params)
        self.opt = resolve_optimizer(optimizer, lr)(self._leaves)

    def step(self, loss_fn):
        """One gradient step on loss_fn(params) -> scalar."""
        loss = loss_fn(self.params)
        set_grads(loss, self._leaves)
        self.opt.step()
        return loss.detach(), self.params

    def parameter_names(self):
        return list(self.params.keys())
