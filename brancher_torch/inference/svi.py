"""Stochastic variational inference and point estimation.

Counterpart of ``brancher_tpu/inference/svi.py`` (lines 37-157 and
188-415): ``perform_inference`` with the inference methods ``ReverseKL``
(negative ELBO), ``MaximumLikelihood`` and ``MAP``, and ``InferenceResult``.

The JAX package runs the whole optimisation as one jitted ``lax.scan``;
here it is a loop of steps on the device, each drawing its random numbers
with the run's ``torch.Generator`` (the data loaders' minibatch, then the
guide's noise), mapping the S samples through the densities with
``torch.func.vmap``, and stepping a ``torch.optim`` optimizer on the
autograd gradient.  The per-step losses stay on the device until the end.

A loss is ``loss_fn(opt_params, generator, num_samples, draws=None)``;
``draws`` = {"data": the loaders' values, "noise": the guide's noise}
replays given numbers instead of drawing (the parity tests feed JAX's).

``WassersteinVariationalGradientDescent`` and
``SteinVariationalGradientDescent`` dispatch to the particle engines of
``particle_inference_tools.py``, as in the JAX package.

``matmul_precision`` follows what JAX does on its accelerator, inside the
run only (``matmul_precision_scope``): "bfloat16" ("default", "fastest")
rounds both operands of every product in the loss (``matmul``, ``@``,
``mm``, ``bmm``, ``einsum``, ``tensordot``, ``linear``, so ``BF.matmul``,
``BF.einsum`` and the ``nn.Linear`` layers of ``BF.BrancherFunction``) to
bf16 and multiplies them in f32, which is exact, with f32 accumulation;
"high" ("tensorfloat32", "bfloat16_3x") runs f32 products as TF32; None,
"highest" or "float32" keep full f32.  The previous state is restored on
exit.  JAX's CPU backend ignores the setting, so the port's bf16 loss has
no CPU reference there (ROADMAP queue 3).

``ReverseKL(enumerate_discrete=True)`` sums the Bernoulli and Categorical
latents out of log p with an unconstrained-space guide: the compiled
model's dispatched enumerated density (``enum_log_density_fn``, the one
``sample(enumerate_discrete=True)`` uses) mapped over the guide's samples.

``mesh=`` (a ``DeviceMesh`` with a ``batch_axis`` dimension; JAX lines
211-228 and 303-325) splits the Monte-Carlo samples over its ranks, under
the SPMD convention of ``parallel/mesh.py``: every rank calls
``perform_inference`` alike, initialises the same parameters from the
key, evaluates ``number_samples / n`` samples (and any minibatch) from a
generator folded with its rank, and averages its loss and gradients over
the ranks after ``backward`` (``average_over_ranks``: one all-reduce a
step), so that every rank's optimizer takes the same step and the
parameters stay identical on every rank.  JAX takes the ``pmean`` of the
loss inside ``shard_map`` and differentiates through it; the gradient is
the same mean.  ``scan_unroll`` is accepted and does nothing: there is no
scan to unroll.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.overrides import TorchFunctionMode

from ..compiler import CompiledModel
from ..config import make_generator
from ..optimizers import detached, resolve_optimizer as _resolve_optimizer, set_grads, trainable_copy
from ..parallel.collectives import Axis, fold_in, mesh_axis, pmean
from .gradient_estimators import GradientEstimator, PathwiseDerivativeEstimator
from .guides import AutoMeanField, DSLGuide

Tensor = torch.Tensor


def _data_draw(p_comp: CompiledModel, p_params, generator, loaders, draws) -> Dict[str, Tensor]:
    if "data" in draws:
        return draws["data"]
    return p_comp.sample_subgraph_one(p_params, generator, loaders) if loaders else {}


class InferenceMethod:
    """Base class for inference-method strategy objects."""

    def make_loss(self, p_comp: CompiledModel, guide) -> Callable:
        raise NotImplementedError


class ReverseKL(InferenceMethod):
    """Negative-ELBO minimization (the reference's default method).

    Every step draws the target's data loaders once and feeds the draw to
    the target and to the guide as ``given`` (an amortised guide reads the
    same minibatch), then evaluates log p of each guide sample.

    enumerate_discrete: with an unconstrained-space guide, sum the
    Bernoulli and Categorical latents out of log p exactly (the compiled
    model's enumeration) instead of asking the guide to sample them."""

    def __init__(self, gradient_estimator: Optional[GradientEstimator] = None,
                 enumerate_discrete: bool = False):
        self.estimator = gradient_estimator or PathwiseDerivativeEstimator()
        self.enumerate_discrete = enumerate_discrete

    def make_loss(self, p_comp: CompiledModel, guide):
        est = self.estimator
        latent_set = set(p_comp.latent_names)
        loaders = tuple(p_comp.data_loader_names)
        # the dispatch of sample(enumerate_discrete=True), made once here
        enum_density = (p_comp.enum_log_density_fn(p_comp.initial_params)
                        if self.enumerate_discrete else None)

        def loss_fn(opt_params, generator, num_samples: int, draws=None):
            draws = draws or {}
            p_params, q_params = opt_params["p"], opt_params["q"]
            given_data = _data_draw(p_comp, p_params, generator, loaders, draws)
            values, log_q = guide.sample_and_log_prob(
                q_params, generator, num_samples, detach=est.detach_samples,
                deterministic=est.deterministic, given=given_data, noise=draws.get("noise"),
            )
            if guide.space == "constrained":
                latents = {k: v for k, v in values.items() if k in latent_set}
                log_p = torch.func.vmap(
                    lambda s: p_comp.log_prob_one(p_params, {**s, **given_data}))(latents)
            elif enum_density is not None:
                log_p = torch.func.vmap(
                    lambda z: enum_density(p_params, z, given_data))(values)
            else:
                log_p = torch.func.vmap(
                    lambda z: p_comp.log_density_z(p_params, z, given_data))(values)
            return est.surrogate_loss(log_p, log_q)

        return loss_fn


class MaximumLikelihood(InferenceMethod):
    """Maximize the observed-data log-likelihood over learnable params;
    latent RVs (if any) are marginalized by prior Monte-Carlo."""

    def make_loss(self, p_comp: CompiledModel, guide):
        observed = set(p_comp.observed_names)

        def loss_fn(opt_params, generator, num_samples: int, draws=None):
            p_params = opt_params["p"]
            store = p_comp._as_store(p_params)

            def one():
                values, _ = p_comp._walk_sample(store, generator, {})
                # the likelihood at the OBSERVED data, not at the model's
                # prior-predictive draws of the observed variables
                latents = {k: v for k, v in values.items() if k not in observed}
                return p_comp.log_likelihood_one(p_params, latents)

            return -torch.mean(torch.stack([one() for _ in range(num_samples)]))

        return loss_fn


class MAP(InferenceMethod):
    """Joint MAP: optimize the unconstrained latent point z together with
    learnable params; loss = -log p(z, data) including Jacobian."""

    def make_loss(self, p_comp: CompiledModel, guide):
        loaders = tuple(p_comp.data_loader_names)

        def loss_fn(opt_params, generator, num_samples: int, draws=None):
            p_params = opt_params["p"]
            given_data = _data_draw(p_comp, p_params, generator, loaders, draws or {})
            return -p_comp.log_density_z(p_params, opt_params["z"], given_data)

        return loss_fn


class WassersteinVariationalGradientDescent(InferenceMethod):
    """Wasserstein VGD by semi-discrete optimal transport of a particle
    ensemble: ``method="sinkhorn"`` (an entropic plan, default) or
    ``"exact"`` (Laguerre-cell dual ascent at rate ``psi_lr``); see
    ``particle_inference_tools.run_wvgd``."""

    def __init__(self, number_particles: int = 50, number_samples: int = 512,
                 proposal_scale: float = 1.0, psi_lr: float = 1.0,
                 step_size: float = 0.5, method: str = "sinkhorn"):
        self.number_particles = number_particles
        self.number_samples = number_samples
        self.proposal_scale = proposal_scale
        self.psi_lr = psi_lr
        self.step_size = step_size
        self.method = method


class SteinVariationalGradientDescent(InferenceMethod):
    """Kernelized particle flow (the SVGD update rule), its own method
    apart from WVGD; see ``particle_inference_tools.run_svgd``."""

    def __init__(self, number_particles: int = 50, kernel_bandwidth: Optional[float] = None):
        self.number_particles = number_particles
        self.kernel_bandwidth = kernel_bandwidth


class InferenceResult:
    def __init__(self, params, loss_curve, guide=None, extras=None):
        self.params = params
        self.loss_curve = loss_curve
        self.guide = guide
        self.extras = extras or {}

    def __repr__(self):
        final = float(self.loss_curve[-1]) if len(self.loss_curve) else float("nan")
        return f"<InferenceResult iterations={len(self.loss_curve)} final_loss={final:.4f}>"


_PRODUCTS = frozenset({"matmul", "__matmul__", "__rmatmul__", "mm", "bmm", "einsum",
                       "tensordot", "linear", "dot", "mv"})


class _Bf16Products(TorchFunctionMode):
    """bf16 operands, f32 accumulation for every product called in scope:
    each floating f32 operand is rounded to bf16 and back before an f32
    product (the product of two bf16 values is exact in f32)."""

    @staticmethod
    def _round(a):
        if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
            return a.to(torch.bfloat16).to(torch.float32)
        if isinstance(a, (list, tuple)):
            return type(a)(_Bf16Products._round(x) for x in a)
        return a

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", None) in _PRODUCTS:
            args = self._round(args)
            kwargs = {k: self._round(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


_PRECISIONS = {None: "float32", "highest": "float32", "float32": "float32",
               "bfloat16": "bfloat16", "default": "bfloat16", "fastest": "bfloat16",
               "high": "tensorfloat32", "tensorfloat32": "tensorfloat32",
               "bfloat16_3x": "tensorfloat32"}


@contextlib.contextmanager
def matmul_precision_scope(matmul_precision: Optional[str]):
    """The products of the block at ``matmul_precision`` (module
    docstring), and the previous state back on exit."""
    if matmul_precision not in _PRECISIONS:
        raise ValueError(f"unknown matmul_precision {matmul_precision!r}")
    mode = _PRECISIONS[matmul_precision]
    previous = torch.get_float32_matmul_precision()
    try:
        if mode == "tensorfloat32":
            torch.set_float32_matmul_precision("high")
        elif mode == "bfloat16":
            torch.set_float32_matmul_precision("highest")
        if mode == "bfloat16":
            with _Bf16Products():
                yield
        else:
            yield
    finally:
        torch.set_float32_matmul_precision(previous)


def average_over_ranks(loss: Tensor, leaves, axis: Axis) -> Tensor:
    """Replace each leaf's ``.grad`` by its mean over the ranks of ``axis``
    and return the mean loss, by one all-reduce of [loss, grads...]."""
    flat = torch.cat([loss.detach().reshape(1).to(torch.float32)]
                     + [p.grad.reshape(-1).to(torch.float32) for p in leaves])
    flat = pmean(flat, axis)
    pos = 1
    for p in leaves:
        n = p.grad.numel()
        p.grad = flat[pos:pos + n].reshape(p.grad.shape).to(p.grad.dtype)
        pos += n
    return flat[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def perform_inference(
    joint_model,
    number_iterations: int = 1000,
    number_samples: int = 10,
    optimizer: Any = "adam",
    lr: float = 0.01,
    inference_method: Optional[InferenceMethod] = None,
    posterior_model=None,
    guide=None,
    key=None,
    params_init: Optional[Dict[str, Any]] = None,
    mesh=None,
    batch_axis: str = "batch",
    progress: bool = False,
    progress_interval: int = 100,
    matmul_precision: Optional[str] = None,
    scan_unroll: int = 1,
    device=None,
) -> InferenceResult:
    """Run SVI / point estimation (reference entry point, SURVEY.md §3.4).

    The guide is chosen by precedence: explicit ``guide`` arg > DSL
    ``posterior_model`` (or one attached via ``set_posterior_model``) >
    automatic mean-field in unconstrained space.

    device: where the run happens; default ``config.device`` ("cuda"),
    which raises when CUDA is absent.  key: an int seed or a
    ``torch.Generator`` on that device.  optimizer: a name ("adam",
    "adamw", "sgd", "rmsprop", "adagrad", each with optax's update rule), a
    ``torch.optim.Optimizer`` class, or a factory params -> optimizer.
    ``matmul_precision`` None or "highest" runs every product in f32: TF32
    stays as PyTorch's default leaves it, off; "bfloat16" and "high" are
    scoped to the run (module docstring).  With
    ``perform_inference._benchmark`` set, the step loop runs three more
    times from the same start and ``perform_inference._last_run_seconds``
    is the best of them, ended by a device synchronize.  mesh, batch_axis:
    split the samples over the mesh's ``batch_axis`` dimension (module
    docstring); ``number_samples`` must divide over it, and the run's
    device defaults to the mesh's device type.  The particle methods
    (WVGD, SVGD) ignore ``mesh``, as in JAX.
    """
    del scan_unroll
    if inference_method is None:
        inference_method = ReverseKL()
    if matmul_precision not in _PRECISIONS:
        raise ValueError(f"unknown matmul_precision {matmul_precision!r}")
    if isinstance(inference_method, WassersteinVariationalGradientDescent):
        from .particle_inference_tools import run_wvgd

        return run_wvgd(
            joint_model, number_iterations=number_iterations,
            number_particles=inference_method.number_particles,
            lr=inference_method.step_size, key=key,
            number_samples=inference_method.number_samples,
            proposal_scale=inference_method.proposal_scale,
            psi_lr=inference_method.psi_lr, method=inference_method.method, device=device)
    if isinstance(inference_method, SteinVariationalGradientDescent):
        from .particle_inference_tools import run_svgd

        return run_svgd(
            joint_model, number_iterations=number_iterations,
            number_particles=inference_method.number_particles, optimizer=optimizer, lr=lr,
            key=key, kernel_bandwidth=inference_method.kernel_bandwidth, device=device)

    axis, local_samples = None, number_samples
    if mesh is not None:
        axis = mesh_axis(mesh, batch_axis)
        if number_samples % axis.size:
            raise ValueError(f"number_samples={number_samples} must divide over mesh "
                             f"axis {batch_axis!r} of size {axis.size}")
        local_samples = number_samples // axis.size
        device = mesh.device_type if device is None else device
    p_comp: CompiledModel = joint_model.compiled(device)
    dev = p_comp.device
    gen = make_generator(key, dev)

    if guide is None:
        q_model = posterior_model or getattr(joint_model, "posterior_model", None)
        if q_model is not None:
            guide = DSLGuide(q_model, device=dev)
        elif not isinstance(inference_method, (MaximumLikelihood, MAP)):
            guide = AutoMeanField(p_comp)

    opt_params: Dict[str, Any] = {"p": dict(p_comp.initial_params)}
    if guide is not None:
        opt_params["q"] = guide.init_params(gen)
    if isinstance(inference_method, MAP):
        opt_params["z"] = p_comp.z_example()
    if params_init:
        opt_params.update(params_init)

    loss_fn = inference_method.make_loss(p_comp, guide)
    make_optimizer = _resolve_optimizer(optimizer, lr)
    # the parameters start replicated; a rank's samples are its own
    draw_gen = gen if axis is None else fold_in(gen, axis.index)
    run_state = draw_gen.get_state()

    def run():
        draw_gen.set_state(run_state)
        params, leaves = trainable_copy(opt_params)
        opt = make_optimizer(leaves)
        losses = torch.empty((number_iterations,), device=dev)
        for i in range(number_iterations):
            with matmul_precision_scope(matmul_precision):
                loss = loss_fn(params, draw_gen, local_samples)
            set_grads(loss, leaves)
            if axis is not None:
                loss = average_over_ranks(loss, leaves, axis)
            opt.step()
            losses[i] = loss.detach()
            if progress and i % progress_interval == 0:
                print(f"[perform_inference] step {i}: loss {float(loss):.4f}", flush=True)
        return detached(params), losses

    out, losses = run()
    if getattr(perform_inference, "_benchmark", False):
        best = math.inf
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            out, losses = run()
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        perform_inference._last_run_seconds = best
    opt_params = out
    loss_curve = losses.cpu().numpy()

    # reference behaviour: record the loss curve on the model
    joint_model.diagnostics["loss curve"] = loss_curve

    extras = {}
    if isinstance(inference_method, MAP):
        with torch.no_grad():
            extras["map_point"] = p_comp.constrain(opt_params["p"], opt_params["z"])
    # push the trained q params back onto the attached posterior model
    if isinstance(guide, DSLGuide):
        guide.comp.initial_params = opt_params["q"]
        joint_model._trained_params = opt_params
    return InferenceResult(opt_params, loss_curve, guide=guide, extras=extras)
