"""MCMC entry point: warmup + sampling, diagnostics.

Counterpart of ``brancher_tpu/inference/mcmc.py``: ``MCMCResult``
(lines 46-91), ``make_potential`` (line 94), the engine dispatch of
``_run_vectorized`` (lines 250-330) and ``sample()`` for
``chain_method="vectorized"`` (lines 454-1069).  ``kernel`` picks the
engine: ``ChEESHMC`` runs ``chees_hmc``, ``HMC`` runs ``hmc_batched``,
anything else vectorized NUTS.

The batched potential ``[C, d] -> ([C], [C, d])`` is, in order of
preference: the caller's ``value_and_grad_fn``; the fused GLM potential
that ``ops.glm.recognize_fused_family`` finds in the model (on CUDA its
hand-written kernel); else autodiff of the compiled log-density,
``torch.func.vmap(torch.func.grad_and_value(...))``.

``fused_leapfrog=True`` gives the HMC and ChEES engines a whole-
trajectory integrator built once from the recognized GLM family
(``FusedFamily.leapfrog``: kernel K5 on CUDA when X passes its size
gate).  As in the JAX package it has no effect under NUTS or when no
family is recognized; unlike it, ``diagnostics["fused_leapfrog"]`` says
whether K5 ran, and ``sample()`` warns when it was asked for and did not.

ESS and R-hat run on the host in numpy (``diagnostics_backend="host"``)
or where the samples are (``"device"``); ``"auto"`` takes the device when
the samples live on CUDA and pass 16 MB, as JAX's rule does
(``brancher_tpu/inference/mcmc.py:1003-1009``).  Either way
``diagnostics["ess"]`` and ``["r_hat"]`` hold numpy arrays.

Not ported yet, and refused with ``NotImplementedError``: the per-chain
and sharded chain methods, ``sample(mass="dense")`` (ChEES's own
``ChEESHMC(mass="dense")`` runs), ``resume_state`` and
``enumerate_discrete`` (ROADMAP queue 1, items 12, 13 and 15).
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler import CompiledModel
from ..config import make_generator
from ..variables import DeterministicVariable
from .adaptation import find_reasonable_step_size_batched
from .chees import ChEESHMC, chees_hmc
from .diagnostics import (
    effective_sample_size,
    effective_sample_size_device,
    potential_scale_reduction,
    potential_scale_reduction_device,
)
from .hmc import HMC
from .nuts import NUTS
from .vectorized_nuts import nuts_batched

Tensor = torch.Tensor


class MCMCResult:
    """Posterior samples + per-draw stats + summary diagnostics."""

    def __init__(self, samples: Dict[str, Tensor], stats: Dict[str, Tensor],
                 diagnostics: Dict[str, Any]):
        self.samples = samples  # {name: [chains, draws, ...]} constrained
        self.stats = stats  # {accept_prob, diverging, num_steps}[chains, draws]
        self.diagnostics = diagnostics

    def posterior_mean(self) -> Dict[str, Tensor]:
        return {k: torch.mean(v.float(), dim=(0, 1)) for k, v in self.samples.items()}

    def posterior_var(self) -> Dict[str, Tensor]:
        return {k: torch.var(v.float(), dim=(0, 1), unbiased=False) for k, v in self.samples.items()}

    def __repr__(self):
        d = self.diagnostics
        return (
            f"<MCMCResult chains×draws={tuple(next(iter(self.samples.values())).shape[:2])} "
            f"divergences={int(d.get('num_divergences', -1))} "
            f"accept={float(d.get('mean_accept_prob', float('nan'))):.3f}>"
        )


def make_potential(
    comp: CompiledModel, params, given: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Callable[[Tensor], Tensor], Callable[[Tensor], Dict[str, Tensor]], Tensor]:
    """Flat potential -log p(z) over unconstrained space + unravel + z0."""

    def potential(z_flat: Tensor) -> Tensor:
        return -comp.log_density_z(params, comp.unravel_z(z_flat), given)

    return potential, comp.unravel_z, torch.zeros((comp.dim,), device=comp.device)


def autodiff_value_and_grad(potential_fn) -> Callable[[Tensor], Tuple[Tensor, Tensor]]:
    """[C, d] -> (log density [C], its gradient [C, d]) by vmapped autograd."""
    gv = torch.func.vmap(torch.func.grad_and_value(lambda zf: -potential_fn(zf)))

    def vg(z):
        g, v = gv(z)
        return v.detach(), g.detach()

    return vg


class _Counted:
    """Counts the calls of a value-and-grad function."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, z):
        self.calls += 1
        return self.fn(z)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


def sample(
    model,
    kernel=None,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    num_chains: int = 4,
    key=None,
    params=None,
    given: Optional[Dict[str, Tensor]] = None,
    init_values: Optional[Dict[str, Tensor]] = None,
    target_accept: Optional[float] = None,
    adapt_step_size: bool = True,
    adapt_mass: bool = True,
    init_step_size: float = 1.0,
    chain_method: str = "vectorized",
    mesh=None,
    chain_axis: str = "chain",
    collect_deterministic: bool = True,
    value_and_grad_fn=None,
    fused_potential: str = "auto",
    fused_leapfrog: bool = False,
    enumerate_discrete: bool = False,
    mass: str = "diag",
    dense_warmup_fraction: float = 0.5,
    resume_state: Optional[Dict[str, Tensor]] = None,
    init_strategy: str = "uniform",
    diagnostics_backend: str = "auto",
    ess_vars: Optional[Sequence[str]] = None,
    jit_runner: bool = True,
    given_key=None,
    device=None,
) -> MCMCResult:
    """Run chain-batched MCMC on a ProbabilisticModel (or a CompiledModel):
    vectorized NUTS, or HMC / ChEES when ``kernel`` is one of those.

    device: where the run happens; default ``config.device`` ("cuda"),
    which raises when CUDA is absent.  A CompiledModel runs on its own
    device.  key: an int seed or a ``torch.Generator`` on that device.

    value_and_grad_fn: optional batched (log density, grad) evaluator
    [C, d] -> ([C], [C, d]); default: the fused GLM potential when the
    model is recognized (``fused_potential`` "auto" or "bf16"), else
    vmapped autodiff.  "bf16" uses bf16 multiplies with f32 accumulation
    in the fused potential (a slightly perturbed density); "off" skips
    the recognizer.

    adapt_mass is read only by the per-chain engines, as in the JAX
    package: the vectorized engine always adapts a diagonal mass.
    jit_runner and given_key exist in the JAX package to avoid retracing
    and re-hashing; there is no trace step here, so they are accepted and
    do nothing.  ``diagnostics["sampler_seconds"]`` is the wall time of the
    engine, ended by a device synchronize.
    """
    del jit_runner, given_key, adapt_mass, chain_axis, dense_warmup_fraction
    if chain_method != "vectorized":
        if chain_method in ("vmap", "shard_map"):
            _not_ported(f"chain_method={chain_method!r}", "ROADMAP queue 1, items 12 and 15")
        raise ValueError(f"unknown chain_method {chain_method!r}")
    if mass not in ("diag", "dense"):
        raise ValueError(f"unknown mass {mass!r}")
    if mass == "dense":
        _not_ported("mass='dense'", "ROADMAP queue 1, item 12")
    if resume_state is not None:
        _not_ported("resume_state", "ROADMAP queue 1, item 12")
    if mesh is not None:
        _not_ported("sharding chains over a mesh", "ROADMAP queue 1, item 15")
    if enumerate_discrete:
        _not_ported("enumerate_discrete", "ROADMAP queue 1, item 13")
    if fused_potential not in ("auto", "bf16", "off"):
        raise ValueError(f"unknown fused_potential {fused_potential!r}")
    if diagnostics_backend not in ("auto", "host", "device", "none"):
        raise ValueError(f"unknown diagnostics_backend {diagnostics_backend!r}")

    if kernel is None:
        kernel = NUTS()
    if target_accept is None:
        target_accept = getattr(kernel, "target_accept", 0.8)
    if isinstance(model, CompiledModel):
        comp = model
        if device is not None and torch.device(device).type != comp.device.type:
            raise ValueError(f"model compiled for {comp.device}, sample() asked for {device}")
    else:
        comp = model.compiled(device)
    dev = comp.device
    gen = make_generator(key, dev)
    if params is None:
        params = comp.initial_params
    potential_fn, unravel, _ = make_potential(comp, params, given)

    # -- fused-potential upgrade (cached per compiled model) ---------------
    fam_name, bf16_active, leapfrog_fn = None, False, None
    if (value_and_grad_fn is None and fused_potential in ("auto", "bf16")
            and params is comp.initial_params and not given):
        if not hasattr(comp, "_fused_family_cache"):
            from ..ops.glm import recognize_fused_family

            comp._fused_family_cache = recognize_fused_family(comp, params)
        fam = comp._fused_family_cache
        if fam is not None:
            dtype = "bf16" if fused_potential == "bf16" else "f32"
            built = comp.__dict__.setdefault("_fused_vg_built", {})
            if dtype not in built:
                built[dtype] = fam.value_and_grad(dtype=dtype)
            value_and_grad_fn = built[dtype]
            fam_name, bf16_active = fam.family, dtype == "bf16"
            if fused_leapfrog:
                if not hasattr(comp, "_fused_leapfrog_built"):
                    comp._fused_leapfrog_built = fam.leapfrog()
                leapfrog_fn = comp._fused_leapfrog_built
    if fused_potential == "bf16" and not bf16_active:
        warnings.warn(
            "fused_potential='bf16' was requested but the bf16 fused "
            "potential is not in use (the GLM probe failed, or a "
            "precondition — default params, no given, no explicit "
            "value_and_grad_fn — does not hold); sampling proceeds with "
            "the f32 path.", stacklevel=2,
        )
    if value_and_grad_fn is None:
        value_and_grad_fn = autodiff_value_and_grad(potential_fn)
    vg = _Counted(value_and_grad_fn)

    # -- initial positions -------------------------------------------------
    dim = comp.dim
    if init_values is not None:
        z_init = comp.ravel_z(comp.unconstrain(params, init_values))
        z0 = z_init.to(torch.float32).expand(num_chains, dim).contiguous()
    elif init_strategy == "uniform":
        # Stan-style default: uniform(-2, 2) in UNCONSTRAINED space
        z0 = torch.rand((num_chains, dim), generator=gen, device=dev) * 4.0 - 2.0
    elif init_strategy == "prior":
        draws = comp.sample(params, gen, num_chains, given)
        latents = {n: draws[n] for n in comp.continuous_latent_names}
        z_tree = torch.func.vmap(lambda vals: comp.unconstrain(params, vals))(latents)
        z0 = comp.ravel_z(z_tree).to(torch.float32).contiguous()
    else:
        raise ValueError(f"unknown init_strategy {init_strategy!r}")

    # -- the engine --------------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_engine = time.perf_counter()
    if num_warmup > 0 and adapt_step_size:
        init_eps = find_reasonable_step_size_batched(
            vg, z0, torch.ones((dim,), device=dev), gen,
            init_step=min(init_step_size, 1.0),
        )
    else:
        init_eps = init_step_size
    max_delta = getattr(kernel, "max_delta_energy", 1000.0)
    extra: Dict[str, Any] = {}
    if isinstance(kernel, ChEESHMC):
        res = chees_hmc(
            vg, z0, num_warmup, num_samples, gen, target_accept=target_accept,
            init_step_size=float(init_eps),
            init_trajectory_length=kernel.init_trajectory_length,
            max_leapfrog=kernel.max_leapfrog, adam_lr=kernel.adam_lr, mass=kernel.mass,
            leapfrog_fn=leapfrog_fn, max_delta_energy=max_delta,
        )
        num_steps = res.num_leapfrog.to(torch.int64)[None, :].expand(num_chains, num_samples)
        extra = {"trajectory_length": res.trajectory_length,
                 "warmup_leapfrog": int(res.warmup_leapfrog)}
    elif isinstance(kernel, HMC):
        from ..ops.batched_hmc import hmc_batched

        res = hmc_batched(
            vg, z0, num_warmup, num_samples, gen,
            num_integration_steps=kernel.num_integration_steps,
            target_accept=target_accept, init_step_size=float(init_eps),
            jitter_steps=kernel.jitter_steps, leapfrog_fn=leapfrog_fn,
            max_delta_energy=max_delta,
        )
        length = kernel.num_integration_steps
        num_steps = torch.full((num_chains, num_samples),
                               (length + 1) // 2 if kernel.jitter_steps else length,
                               dtype=torch.int64, device=dev)
    else:
        res = nuts_batched(
            vg, z0, num_warmup, num_samples, gen,
            max_depth=getattr(kernel, "max_depth", 10),
            target_accept=target_accept, init_step_size=float(init_eps),
            max_delta_energy=max_delta,
        )
        num_steps = res.num_leapfrog[None, :].expand(num_chains, num_samples)
        extra = {"warmup_leapfrog": res.warmup_leapfrog, "chain_leapfrog": res.chain_leapfrog}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sampler_seconds = time.perf_counter() - t_engine
    # K5 ran when the engine integrated with leapfrog_fn (NUTS takes none;
    # ChEES drops it under dense mass) and that is K5's wrapper on the card
    k5_ran = (getattr(res, "used_leapfrog_fn", False)
              and getattr(leapfrog_fn, "uses_kernel", False))
    if fused_leapfrog and not k5_ran:
        warnings.warn(
            "fused_leapfrog=True was requested but the fused leapfrog kernel "
            "did not run (the engine is not HMC/ChEES with diagonal mass, no "
            "GLM family was recognized, X fails the kernel's size gate, or "
            "the run is on the CPU); the engine integrated with a loop of "
            "value+grad calls.", stacklevel=2,
        )

    # -- constrain + collect -----------------------------------------------
    names_out = list(comp.continuous_latent_names)
    if collect_deterministic:
        names_out += [v.name for v in comp.order
                      if isinstance(v, DeterministicVariable) and v.parents]
    zs = res.samples
    c, s = zs.shape[0], zs.shape[1]

    def one(zf):
        vals = comp.constrain(params, unravel(zf), given)
        return {n: vals[n] for n in names_out}

    with torch.no_grad():
        flat_vals = torch.func.vmap(one)(zs.reshape(c * s, dim))
    samples = {k: v.reshape((c, s) + tuple(v.shape[1:])) for k, v in flat_vals.items()}

    stats = {
        "accept_prob": res.accept_prob,
        "diverging": res.diverging,
        "num_steps": num_steps,
    }
    diagnostics: Dict[str, Any] = {
        "num_divergences": int(res.diverging.sum()),
        "mean_accept_prob": float(res.accept_prob.mean()),
        "step_size": res.step_size,
        "inv_mass": res.inv_mass,
        "sampler_seconds": sampler_seconds,
        **extra,
        "total_leapfrog_steps": int(num_steps.sum()),
        "value_and_grad_calls": vg.calls,
        "host_syncs": res.host_syncs,
        "fused_family": fam_name,
        "fused_dtype": ("bf16" if bf16_active else "f32") if fam_name else None,
        "fused_leapfrog": k5_ran,
        "device": str(dev),
    }
    mode = diagnostics_backend
    if mode == "auto":
        total_bytes = sum(v.numel() * 4 for v in samples.values())
        mode = "device" if dev.type == "cuda" and total_bytes > 16 * 2**20 else "host"
    if mode != "none":
        if ess_vars is not None:
            diag_names = list(ess_vars)
            conditioned = [n for n in diag_names if given and n in given]
            if conditioned:
                raise ValueError(
                    f"ess_vars {conditioned} are conditioned via `given` "
                    f"— constant across draws, no ESS/R-hat")
            missing = [n for n in diag_names if n not in samples]
            if missing:
                raise ValueError(
                    f"ess_vars {missing} not in collected samples "
                    f"(available: {sorted(samples)})")
        else:
            diag_names = list(comp.continuous_latent_names)
        ess, rhat = {}, {}
        for n in diag_names:
            if given and n in given:
                continue  # conditioned: constant across draws (0/0 R-hat)
            x = samples[n].detach()
            event_shape = tuple(x.shape[2:])
            if mode == "device":
                ess[n] = effective_sample_size_device(x).cpu().numpy().reshape(event_shape)
                rhat[n] = potential_scale_reduction_device(x).cpu().numpy().reshape(event_shape)
                continue
            flat = x.cpu().numpy().reshape(x.shape[0], x.shape[1], -1)
            ess[n] = np.asarray(effective_sample_size(flat)).reshape(event_shape)
            rhat[n] = np.asarray(potential_scale_reduction(flat)).reshape(event_shape)
        diagnostics["diagnostics_backend"] = mode
        diagnostics["ess"] = ess
        diagnostics["r_hat"] = rhat
    return MCMCResult(samples, stats, diagnostics)
