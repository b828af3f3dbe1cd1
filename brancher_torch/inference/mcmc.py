"""MCMC entry point: warmup + sampling, diagnostics.

Counterpart of ``brancher_tpu/inference/mcmc.py``: ``MCMCResult``
(lines 46-91, ``to_pandas`` and ``posterior_predictive`` among them), ``make_potential`` (line 94), ``_run_single_chain`` (lines
157-230), the engine dispatch of ``_run_vectorized`` (lines 250-330) and
``sample()`` (lines 454-1069) with ``chain_method`` "vectorized", "vmap"
or "shard_map", ``mesh``, ``mass`` "diag" or "dense", and ``resume_state``.  ``kernel``
picks the vectorized engine: ``ChEESHMC`` runs ``chees_hmc``, ``HMC``
runs ``hmc_batched``, anything else vectorized NUTS (draw-pipelined with
``NUTS(pipelined=True)``).  ``chain_method="vmap"`` runs the kernel's
per-chain ``make_step`` (NUTS, HMC) in ``_run_single_chain``, as a masked
batch over the chains (``nuts.py``), with the cross-chain means that JAX
takes with ``pmean``.

The batched potential ``[C, d] -> ([C], [C, d])`` of the vectorized
engines is, in order of preference: the caller's ``value_and_grad_fn``;
the fused GLM potential that ``ops.glm.recognize_fused_family`` finds in
the model (on CUDA its hand-written kernel); else autodiff of the
compiled log-density (``hmc.autodiff_value_and_grad``).
As in the JAX package the per-chain engines use only the autodiff one,
so they launch no kernel, and a family that is not ``auto_upgradable``
(the softmax ``CategoricalFusedFamily``) leaves the model on autodiff;
``fused_potential="bf16"`` on it samples in f32 and warns.  A discrete
latent that is neither given nor enumerated raises the compiler's
``ValueError``, as in JAX.

``mass="dense"`` whitens the posterior (JAX ``mcmc.py:794-879``): stage A
runs the vectorized engine with a diagonal mass for part of the warmup
and a few draws, and stage B runs it again on ``vg_t(zt) = (v, g @ L)``
with ``(v, g) = vg(mu + zt @ L.T)``, where ``mu`` and ``L L^T`` are stage
A's mean and covariance: the same value+grad, kernel and all, inside the
affine map.  ``diagnostics["resume_state"]`` holds what a later
``sample(resume_state=...)`` needs to go on without warmup.

``fused_leapfrog=True`` gives the HMC and ChEES engines a whole-
trajectory integrator built once from the recognized GLM family
(``FusedFamily.leapfrog``: kernel K5 on CUDA when X passes its size
gate).  As in the JAX package it has no effect under NUTS, under dense
mass, on the per-chain engines, or when no family is recognized; unlike
it, ``diagnostics["fused_leapfrog"]`` says whether K5 ran, and
``sample()`` warns when it was asked for and did not.

ESS and R-hat run on the host in numpy (``diagnostics_backend="host"``)
or where the samples are (``"device"``); ``"auto"`` takes the device when
the samples live on CUDA and pass 16 MB, as JAX's rule does
(``brancher_tpu/inference/mcmc.py:1003-1009``).  Either way
``diagnostics["ess"]`` and ``["r_hat"]`` hold numpy arrays.

``enumerate_discrete=True`` sums the Bernoulli and Categorical latents out
of the potential (``compiled.enum_log_density_fn``, JAX ``mcmc.py:598-624``):
every engine then samples the marginal of the continuous latents on the
autodiff value+grad (``fused_potential`` is forced "off", so the GLM
recognizer is not asked), and the discrete latents are pinned to zeros for
``constrain`` so that their deterministic descendants stay defined.  The
potential is cached on the compiled model (``_enum_potential_cache``), a
FIFO of eight keyed by ``given``'s content, as in JAX; a ``given`` leaf
over 16 MB is neither copied to the host nor hashed, and its call builds a
fresh potential.  The autodiff value+grad (``GraphedValueAndGrad``) is kept
in a FIFO of the same kind (``_autodiff_vg_cache``), keyed also by whether
the potential is enumerated, so that a second call on the same model and
data replays the CUDA graphs of the first (``diagnostics[
"value_and_grad_captures"]`` and ``["value_and_grad_capture_seconds"]``
read 0 then).

Sharded chains (``mesh=``, a ``DeviceMesh`` with a ``chain_axis``
dimension; the SPMD convention of ``parallel/mesh.py``): every rank calls
``sample()`` with the same arguments, draws the same global z0 [C, d],
runs its block of C / n chains on a generator folded with its rank, and
returns the global result gathered in rank order.  ``chain_method=
"vectorized"`` is JAX's ``_run_vectorized`` under ``shard_map``
(``mcmc.py:233-440``): the fused-potential probe is unchanged, so a
recognized model runs its kernel on the rank's [C / n, d] block, and the
warmup's step size and mass reach consensus over the ranks (``axis`` of
the engines); ``warmup_leapfrog`` and ``chain_leapfrog`` are the means
over ranks.  ``"shard_map"`` is the per-chain runner over the rank's block
(``mcmc.py:887-935``), its chain means the means over ranks of each
rank's chain means.  ``mass="dense"`` runs stage A sharded, takes the
statistics of the gathered draws and runs stage B sharded (``:819`` and
``:863``); the pipelined engine's warmup is sharded and its draws need no
collective.  ``chain_method="vmap"`` ignores ``mesh``, as in JAX.
``value_and_grad_calls`` and ``host_syncs`` count this rank's.

With ``metrics.tracing()`` on, a call is a ``sample`` span with a call id
of its own, cut into ``sample.prepare`` (with ``sample.recognize``, the
GLM recognizer's probe and the fused value+grad's build, where the call
asks for them), ``sample.engine`` (whose duration
is ``sampler_seconds``), ``sample.constrain`` and ``sample.diagnostics``;
the engine's counters on the device are read once, at the end of
``sample.engine``.  Off, ``sampler_seconds`` is timed on the same stamps.
"""
from __future__ import annotations

import copy
import hashlib
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import metrics as _metrics
from ..compiler import CompiledModel
from ..config import make_generator
from ..parallel.collectives import Axis, all_gather, fold_in, local_block, mesh_axis
from ..variables import DeterministicVariable
from .adaptation import (
    build_warmup_schedule,
    da_init,
    da_restart,
    da_update,
    find_reasonable_step_size,
    find_reasonable_step_size_batched,
    pmean_if,
    welford_init,
    welford_update,
    welford_variance,
)
from .chees import ChEESHMC, chees_hmc
from .diagnostics import (
    effective_sample_size,
    effective_sample_size_device,
    potential_scale_reduction,
    potential_scale_reduction_device,
)
from .hmc import HMC, GraphedValueAndGrad, TorchChainRandom, autodiff_value_and_grad, init_chain_state
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

    def to_pandas(self):
        """The draws of every chain, one row each, as a pandas DataFrame."""
        from ..pandas_interface import sample_dict_to_dataframe

        return sample_dict_to_dataframe(
            {k: v.detach().cpu().reshape((-1,) + tuple(v.shape[2:])) for k, v in self.samples.items()})

    def posterior_predictive(self, model, num_draws: int = 100, key=None) -> Dict[str, Tensor]:
        """Sample the model's variables, the observed ones included, given
        ``num_draws`` posterior draws thinned uniformly from all chains
        without replacement, on the samples' device.  key: an int seed
        (default 0) or a generator there.  JAX thins with
        ``jax.random.choice(..., replace=False)``; this takes the first
        ``num_draws`` of a ``torch.randperm`` from the same generator as the
        draws, so it matches JAX in distribution only."""
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in self.samples.items()}
        first = next(iter(flat.values()))
        total, dev = first.shape[0], first.device
        if num_draws > total:
            raise ValueError(f"num_draws={num_draws} exceeds the {total} posterior draws")
        gen = make_generator(0 if key is None else key, dev)
        idx = torch.randperm(total, generator=gen, device=dev)[:num_draws]
        given = {k: v[idx] for k, v in flat.items()}
        return model.get_sample_dict(num_draws, key=gen, input_values=given, device=dev)

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


# a given leaf over this many bytes is not keyed: copying it to the host
# and hashing it on every call would cost more than the cache saves (JAX
# ``mcmc.py:126-133``)
_GIVEN_KEY_MAX_BYTES = 1 << 24


def _given_key(given) -> Optional[tuple]:
    """A key for ``given``'s content (names, shapes, dtypes and the sha1
    of the bytes), read once a ``sample()`` call: what the potential
    caches are keyed by, as JAX keys them (``_content_key``, ``mcmc.py:
    109-135``).  None, before any host copy, when a leaf passes 16 MB: the
    call then builds a fresh potential and caches nothing."""
    if not given:
        return ()
    leaves = []
    for k in sorted(given):
        t = torch.as_tensor(given[k])
        if t.numel() * t.element_size() > _GIVEN_KEY_MAX_BYTES:
            return None
        leaves.append((k, t))
    key = []
    for k, t in leaves:
        a = np.ascontiguousarray(t.detach().cpu().numpy())
        key.append((k, a.shape, str(a.dtype), hashlib.sha1(a.tobytes()).hexdigest()))
    return tuple(key)


def _comp_cache(comp, attr: str, key, build, cap: int = 8):
    """A FIFO of ``cap`` entries kept on the compiled model under ``attr``
    (JAX ``_comp_cache``, ``mcmc.py:140-155``): the entry of ``key``, else
    ``build()``, stored after the oldest entry is evicted when full."""
    cache = comp.__dict__.setdefault(attr, {})
    if key in cache:
        return cache[key]
    value = build()
    if len(cache) >= cap:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value


def make_enum_potential(comp: CompiledModel, params, given, unravel) -> Callable[[Tensor], Tensor]:
    """The flat potential with the discrete latents summed out:
    ``-enum_fn(params, unravel(z), given)`` over the dispatched density."""
    enum_fn = comp.enum_log_density_fn(params, given)

    def enum_potential(z_flat: Tensor) -> Tensor:
        return -enum_fn(params, unravel(z_flat), given)

    return enum_potential


class _Counted:
    """Counts the calls of a value-and-grad function."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, z):
        self.calls += 1
        return self.fn(z)


def _gathered(zs: Tensor, stats: Dict[str, Tensor], axis: Optional[Axis]):
    """The global samples [C, S, d] and stats [C, S] from every rank's
    block, in rank order (as ``out_specs=P(chain_axis)``), on the samples'
    device (NCCL gathers card tensors only; NUTS counts its leaves on the
    host)."""
    if axis is None:
        return zs, stats
    return all_gather(zs, axis), {k: all_gather(v.to(zs.device), axis) for k, v in stats.items()}


def _run_vectorized(kernel, vg, z0, num_warmup, num_samples, gen, target_accept,
                    init_step_size, inv_mass0=None, leapfrog_fn=None, adapt_step_size=True,
                    axis: Optional[Axis] = None):
    """One run of the chain-batched engine that ``kernel`` picks: returns
    (samples [C, S, d], stats {accept_prob, diverging, num_steps} [C, S],
    info), as JAX's ``_run_vectorized`` (its ``run``/``_run_inner``).
    With ``axis`` (sharded chains) z0 is the global [C, d]: this rank runs
    its block and returns the gathered result."""
    if axis is not None:
        z0 = local_block(z0, axis, "num_chains")
    c, dim = z0.shape
    dev = z0.device
    if num_warmup > 0 and adapt_step_size:
        im0 = torch.ones((dim,), device=dev) if inv_mass0 is None else inv_mass0
        init_eps = find_reasonable_step_size_batched(vg, z0, im0, gen,
                                                     init_step=min(init_step_size, 1.0),
                                                     axis=axis)
    else:
        init_eps = init_step_size
    max_delta = getattr(kernel, "max_delta_energy", 1000.0)
    if isinstance(kernel, ChEESHMC):
        res = chees_hmc(
            vg, z0, num_warmup, num_samples, gen, target_accept=target_accept,
            init_step_size=float(init_eps),
            init_trajectory_length=kernel.init_trajectory_length,
            max_leapfrog=kernel.max_leapfrog, adam_lr=kernel.adam_lr, mass=kernel.mass,
            inv_mass0=inv_mass0, leapfrog_fn=leapfrog_fn, max_delta_energy=max_delta,
            axis=axis,
        )
        num_steps = res.num_leapfrog.to(torch.int64)[None, :].expand(c, num_samples)
        info = {"trajectory_length": res.trajectory_length,
                "warmup_leapfrog": int(res.warmup_leapfrog)}
    elif isinstance(kernel, HMC):
        from ..ops.batched_hmc import hmc_batched

        res = hmc_batched(
            vg, z0, num_warmup, num_samples, gen,
            num_integration_steps=kernel.num_integration_steps,
            target_accept=target_accept, init_step_size=float(init_eps),
            jitter_steps=kernel.jitter_steps, inv_mass0=inv_mass0, leapfrog_fn=leapfrog_fn,
            max_delta_energy=max_delta, axis=axis,
        )
        length = kernel.num_integration_steps
        num_steps = torch.full((c, num_samples),
                               (length + 1) // 2 if kernel.jitter_steps else length,
                               dtype=torch.int64, device=dev)
        info = {}
    else:
        res = nuts_batched(
            vg, z0, num_warmup, num_samples, gen,
            max_depth=getattr(kernel, "max_depth", 10),
            target_accept=target_accept, init_step_size=float(init_eps),
            max_delta_energy=max_delta, inv_mass0=inv_mass0,
            pipeline=getattr(kernel, "pipelined", False),
            lookahead=getattr(kernel, "lookahead", 16), axis=axis,
        )
        num_steps = res.num_leapfrog[None, :].expand(c, num_samples)
        info = {"warmup_leapfrog": res.warmup_leapfrog, "chain_leapfrog": res.chain_leapfrog,
                "sampling_seconds": res.sampling_seconds}
    stats = {"accept_prob": res.accept_prob, "diverging": res.diverging, "num_steps": num_steps}
    info.update(step_size=res.step_size, inv_mass=res.inv_mass, host_syncs=res.host_syncs,
                used_leapfrog_fn=getattr(res, "used_leapfrog_fn", False))
    if axis is not None:
        # each rank's loop counts differ: reported as their mean over ranks
        for k in ("warmup_leapfrog", "chain_leapfrog"):
            if k in info:
                info[k] = pmean_if(torch.as_tensor(info[k], dtype=torch.float32, device=dev), axis)
        if "warmup_leapfrog" in info:
            info["warmup_leapfrog"] = float(info["warmup_leapfrog"])
    samples, stats = _gathered(res.samples, stats, axis)
    return samples, stats, info


def _run_single_chain(kernel_step, vg, z0, num_warmup, num_samples, gen, target_accept,
                      adapt_step_size, adapt_mass, init_step_size, axis: Optional[Axis] = None):
    """JAX's per-chain run (``_run_single_chain``) over a [C, d] block:
    warmup with dual averaging on the mean accept probability over chains,
    each chain's Welford variance in the slow windows and their mean as
    the shared diagonal mass at each window end; then the draws.  Where
    JAX takes ``pmean`` over the chain axis (the probed step, the accept
    probability, the variance) this takes the mean over chains; with
    ``axis`` (``chain_method="shard_map"``) this rank runs its block of the
    global z0, the mean is the mean over ranks of each rank's chain mean,
    and the result is gathered."""
    c_all = z0.shape[0]
    if axis is not None:
        z0 = local_block(z0, axis, "num_chains")
    c, dim = z0.shape
    dtype, dev = z0.dtype, z0.device
    rng = TorchChainRandom(gen)
    state = init_chain_state(vg, z0)
    inv_mass = torch.ones((dim,), dtype=dtype, device=dev)
    syncs = 0
    if adapt_step_size and num_warmup > 0:
        step0 = pmean_if(torch.mean(find_reasonable_step_size(
            vg, z0, inv_mass, gen, init_step=init_step_size, target=target_accept)), axis)
    else:
        step0 = torch.tensor(init_step_size, dtype=dtype, device=dev)
    da = da_init(step0)
    welford = welford_init(dim, dtype, dev, batch=(c,))
    in_slow, window_end = build_warmup_schedule(num_warmup)
    for i in range(num_warmup):
        state, stats = kernel_step(rng, state, torch.exp(da.log_step), inv_mass)
        syncs += stats.pop("host_syncs")
        da = da_update(da, pmean_if(torch.mean(stats["accept_prob"]), axis),
                       target_accept=target_accept)
        if adapt_mass:
            if in_slow[i]:
                welford = welford_update(welford, state.z)
            if window_end[i]:
                inv_mass = pmean_if(torch.mean(welford_variance(welford), dim=0), axis)
                welford = welford_init(dim, dtype, dev, batch=(c,))
        if window_end[i]:
            da = da_restart(da)
    step_final = torch.exp(da.log_step_avg) if num_warmup > 0 and adapt_step_size else step0

    zs = torch.empty((num_samples, c, dim), dtype=dtype, device=dev)
    draws = []
    for s in range(num_samples):
        state, stats = kernel_step(rng, state, step_final, inv_mass)
        syncs += stats.pop("host_syncs")
        zs[s] = state.z
        draws.append(stats)
    stats = {k: torch.stack([st[k] for st in draws], dim=1) for k in (draws[0] if draws else ())}
    info = {"step_size": step_final.expand(c_all), "inv_mass": inv_mass.expand(c_all, dim),
            "host_syncs": syncs}
    zs, stats = _gathered(zs.transpose(0, 1), stats, axis)
    return zs, stats, info


def dense_statistics(zs_a: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Stage A's draws [C, S, d] -> (mu [d], cov [d, d], L [d, d]): their
    mean, covariance (ddof 1, as ``jnp.cov``) plus 1e-6 I, and its
    Cholesky factor (JAX ``mcmc.py:826-832``)."""
    flat = zs_a.reshape(-1, zs_a.shape[-1])
    dim = flat.shape[-1]
    mu = torch.mean(flat, dim=0)
    cov = torch.cov(flat.T).reshape(dim, dim) + 1e-6 * torch.eye(dim, dtype=flat.dtype, device=flat.device)
    return mu, cov, torch.linalg.cholesky(cov)


def whiten(vg, mu: Tensor, chol: Tensor):
    """The stage-B value+grad over whitened zt, z = mu + zt @ L.T: (v, g @ L)
    with (v, g) = vg(z) (JAX ``mcmc.py:839-846``)."""

    def vg_t(zt):
        v, g = vg(mu[None, :] + zt @ chol.T)
        return v, g @ chol

    return vg_t


def whitened(z: Tensor, mu: Tensor, chol: Tensor) -> Tensor:
    """zt with z = mu + zt @ L.T, for z [C, d]."""
    return torch.linalg.solve_triangular(chol, (z - mu[None, :]).T, upper=False).T


def _run_dense(kernel, vg, z0, num_warmup, num_samples, gen, target_accept, init_step_size,
               adapt_step_size, dense_warmup_fraction, dense_resume, inv_mass0, axis=None):
    """``mass="dense"`` (JAX ``mcmc.py:794-879``): stage A, a diagonal-mass
    run of part of the warmup and a few draws, estimates the posterior's
    mean and covariance, unless ``dense_resume`` carries them; stage B runs
    the same engine on the whitened value+grad.  Returns (samples, stats,
    info, the resume payload's dense part, stage A's line or None).  With
    ``axis`` both stages run sharded and the statistics come from stage
    A's gathered draws, the same on every rank."""
    dev = z0.device
    stage_a = None
    if dense_resume is not None:
        mu = torch.as_tensor(dense_resume["dense_mu"], dtype=torch.float32, device=dev)
        chol = torch.as_tensor(dense_resume["dense_L"], dtype=torch.float32, device=dev)
        dim = mu.shape[0]
        cov = torch.as_tensor(dense_resume["inv_mass"], dtype=torch.float32, device=dev).reshape(dim, dim)
        z_last, warm_a = z0, 0
    else:
        warm_a = min(max(int(num_warmup * dense_warmup_fraction), 50), num_warmup)
        draws_a = max(min(num_samples, 200), 50)
        calls = vg.calls
        zs_a, stats_a, info_a = _run_vectorized(
            kernel, vg, z0, warm_a, draws_a, gen, target_accept, init_step_size,
            inv_mass0=inv_mass0, adapt_step_size=adapt_step_size, axis=axis)
        mu, cov, chol = dense_statistics(zs_a)
        z_last = zs_a[:, -1]
        stage_a = {"num_warmup": warm_a, "num_samples": draws_a,
                   "warmup_leapfrog": info_a.get("warmup_leapfrog"),
                   "sampling_leapfrog": int(stats_a["num_steps"][0].sum()),
                   "value_and_grad_calls": vg.calls - calls,
                   "host_syncs": info_a["host_syncs"]}
    zs_t, stats, info = _run_vectorized(
        kernel, whiten(vg, mu, chol), whitened(z_last, mu, chol), num_warmup - warm_a,
        num_samples, gen, target_accept, init_step_size,
        inv_mass0=inv_mass0 if dense_resume is not None else None,
        adapt_step_size=adapt_step_size, axis=axis)
    zs = mu[None, None, :] + torch.einsum("csd,ed->cse", zs_t, chol)
    ckpt = {"dense_mu": mu, "dense_L": chol, "dense_inner_inv_mass": info["inv_mass"]}
    info["inv_mass"] = cov  # report the dense metric actually used
    if stage_a is not None:
        info["host_syncs"] += stage_a["host_syncs"]
    return zs, stats, info, ckpt, stage_a


@_metrics.traced_call("sample")
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

    chain_method: "vectorized" (the chain-batched engines), "vmap" (the
    kernel's per-chain ``make_step``, NUTS or HMC; launches no kernel and
    ignores ``value_and_grad_fn``, as in the JAX package) or "shard_map"
    ("vmap" sharded over ``mesh``).  adapt_mass is
    read only by the per-chain engines: the vectorized ones always adapt a
    diagonal mass.  mass="dense" (vectorized only) whitens the posterior
    with stage A's covariance, ``dense_warmup_fraction`` of the warmup;
    with no warmup and no resume it samples with diagonal mass, as JAX
    does.  resume_state: a run's ``diagnostics["resume_state"]`` (through
    ``torch.save``/``torch.load`` if need be); the resumed run has no
    warmup and starts from its draws, step size and mass (and ChEES's
    trajectory length).
    mesh, chain_axis: shard the chains over the mesh's ``chain_axis``
    dimension (module docstring): every rank calls ``sample()`` alike and
    gets the global result; ``num_chains`` must divide over it, and the
    run's device defaults to the mesh's device type.  "shard_map" without
    a mesh runs as "vmap".
    jit_runner and given_key exist in the JAX package to avoid retracing
    and re-hashing; there is no trace step here, so they are accepted and
    do nothing.  ``diagnostics["sampler_seconds"]`` is the wall time of the
    engine, ended by a device synchronize.
    """
    del jit_runner, given_key
    tr = _metrics._tracer
    if tr is not None:
        stage = tr.open("sample.prepare")
    if chain_method not in ("vectorized", "vmap", "shard_map"):
        raise ValueError(f"unknown chain_method {chain_method!r}")
    axis = None
    if mesh is not None and chain_method != "vmap":  # vmap ignores the mesh, as in JAX
        axis = mesh_axis(mesh, chain_axis)
        if num_chains % axis.size:
            raise ValueError(f"num_chains={num_chains} must divide over mesh axis "
                             f"{chain_axis!r} of size {axis.size}")
        if device is None and not isinstance(model, CompiledModel):
            device = mesh.device_type
    if mass not in ("diag", "dense"):
        raise ValueError(f"unknown mass {mass!r}")
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
    gck = _given_key(given) if params is comp.initial_params else None
    if gck:
        # the cached potentials keep the given of the call that built them:
        # a copy, so that a caller's later in-place change to its arrays
        # cannot reach a later call whose content matches the key
        given = {k: v.clone() if isinstance(v, torch.Tensor) else np.array(v, copy=True)
                 for k, v in given.items()}
    potential_fn, unravel, _ = make_potential(comp, params, given)
    per_chain = chain_method in ("vmap", "shard_map")
    if enumerate_discrete:
        # the discrete latents summed out inside the potential: every engine
        # samples the marginal on the autodiff value+grad (JAX mcmc.py:598-624)
        if gck is not None:
            potential_fn = _comp_cache(comp, "_enum_potential_cache", gck,
                                       lambda: make_enum_potential(comp, params, given, unravel))
        else:
            potential_fn = make_enum_potential(comp, params, given, unravel)
        fused_potential = "off"

    # -- fused-potential upgrade (cached per compiled model) ---------------
    fam_name, bf16_active, leapfrog_fn = None, False, None
    if (value_and_grad_fn is None and not per_chain and fused_potential in ("auto", "bf16")
            and params is comp.initial_params and not given):
        if tr is not None:
            recognize = tr.open("sample.recognize")
        if not hasattr(comp, "_fused_family_cache"):
            from ..ops.glm import recognize_fused_family

            comp._fused_family_cache = recognize_fused_family(comp, params)
        fam = comp._fused_family_cache
        if fam is not None and not getattr(fam, "auto_upgradable", True):
            fam = None  # the softmax family: autodiff, as in JAX (mcmc.py:640-641)
        if fam is not None and fused_potential == "bf16" and fam.family not in (
                "bernoulli_logit", "normal_learned"):
            fam = None  # bf16 covers the two dense-matmul families
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
        if tr is not None:
            tr.close(recognize)
    if fused_potential == "bf16" and not bf16_active:
        warnings.warn(
            "fused_potential='bf16' was requested but the bf16 fused "
            "potential is not in use (the GLM probe failed, the family "
            "is unsupported, or a precondition — chain_method='vectorized', default params, no "
            "given, no explicit value_and_grad_fn — does not hold); sampling "
            "proceeds with the f32 path.", stacklevel=2,
        )
    if value_and_grad_fn is None or per_chain:
        if gck is not None:
            # kept beside the potential, so that a second call on the same
            # model and data replays the CUDA graphs the first one captured;
            # the potential holds ``params``, so its id is not reused while
            # the entry lives
            value_and_grad_fn = _comp_cache(
                comp, "_autodiff_vg_cache", (gck, bool(enumerate_discrete), id(params)),
                lambda: autodiff_value_and_grad(potential_fn))
        else:
            value_and_grad_fn = autodiff_value_and_grad(potential_fn)
    graphed = isinstance(value_and_grad_fn, GraphedValueAndGrad)
    graphs0 = len(value_and_grad_fn.graphs) if graphed else 0
    capture0 = value_and_grad_fn.capture_seconds if graphed else 0.0
    vg = _Counted(value_and_grad_fn)
    if per_chain and not hasattr(kernel, "make_step"):
        raise ValueError(f"kernel {type(kernel).__name__} requires chain_method='vectorized'")

    # -- resume from a checkpointed sampler state (skips warmup) -----------
    inv_mass0, dense_resume = None, None
    if resume_state is not None:
        if chain_method != "vectorized":
            raise ValueError("resume_state is supported with chain_method='vectorized'")
        num_warmup = 0
        init_step_size = float(resume_state["step_size"])
        adapt_step_size = False
        if mass == "dense":
            # the checkpoint carries the affine map and the inner engine's
            # whitened-space diagonal mass: stage B resumes as it was
            if "dense_mu" not in resume_state or "dense_L" not in resume_state:
                raise ValueError(
                    "mass='dense' resume requires a resume_state produced "
                    "by a mass='dense' run (missing dense_mu/dense_L)")
            dense_resume = resume_state
            inv_mass0 = resume_state["dense_inner_inv_mass"]
        else:
            if "dense_mu" in resume_state:
                # its inv_mass is the [d, d] covariance, not a diagonal mass
                raise ValueError(
                    "resume_state was produced by a mass='dense' run — "
                    "pass mass='dense' to resume it")
            inv_mass0 = resume_state["inv_mass"]
        inv_mass0 = torch.as_tensor(inv_mass0, dtype=torch.float32, device=dev)
        if "trajectory_length" in resume_state and hasattr(kernel, "init_trajectory_length"):
            # ChEES resumes its adapted length (a copy: the caller's kernel
            # may be reused)
            kernel = copy.copy(kernel)
            kernel.init_trajectory_length = float(resume_state["trajectory_length"])

    # -- initial positions -------------------------------------------------
    dim = comp.dim
    if resume_state is not None:
        z0 = torch.as_tensor(resume_state["z"], dtype=torch.float32, device=dev)
        if z0.shape[0] != num_chains:
            raise ValueError(f"resume_state has {z0.shape[0]} chains, expected {num_chains}")
    elif init_values is not None:
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
    if mass == "dense" and chain_method != "vectorized":
        raise ValueError("mass='dense' requires chain_method='vectorized'")

    # -- the engine --------------------------------------------------------
    # a sharded run draws its chains' numbers from a generator folded with
    # its rank (JAX fold_in(key, axis_index), mcmc.py:401-403)
    run_gen = gen if axis is None else fold_in(gen, axis.index)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_engine = time.perf_counter_ns()
    if tr is not None:
        tr.close(stage, t_engine)
        stage = tr.open("sample.engine", t_engine)
    dense_ckpt, stage_a = None, None
    if per_chain:
        zs, stats, info = _run_single_chain(
            kernel.make_step(potential_fn, vg), vg, z0, num_warmup, num_samples, run_gen,
            target_accept, adapt_step_size, adapt_mass, init_step_size, axis=axis)
    elif mass == "dense" and (num_warmup > 0 or dense_resume is not None):
        zs, stats, info, dense_ckpt, stage_a = _run_dense(
            kernel, vg, z0, num_warmup, num_samples, run_gen, target_accept, init_step_size,
            adapt_step_size, dense_warmup_fraction, dense_resume, inv_mass0, axis=axis)
    else:
        zs, stats, info = _run_vectorized(
            kernel, vg, z0, num_warmup, num_samples, run_gen, target_accept, init_step_size,
            inv_mass0=inv_mass0, leapfrog_fn=leapfrog_fn, adapt_step_size=adapt_step_size,
            axis=axis)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter_ns()
    sampler_seconds = (t_end - t_engine) * 1e-9
    if tr is not None:
        tr.close(stage, t_end)
        tr.flush()
        stage = tr.open("sample.constrain")
    # K5 ran when the engine integrated with leapfrog_fn (NUTS, the
    # per-chain engines and dense mass take none; ChEES drops it under its
    # own dense mass) and that is K5's wrapper on the card
    k5_ran = (info.get("used_leapfrog_fn", False)
              and getattr(leapfrog_fn, "uses_kernel", False))
    if fused_leapfrog and not k5_ran:
        warnings.warn(
            "fused_leapfrog=True was requested but the fused leapfrog kernel "
            "did not run (the engine is not vectorized HMC/ChEES with diagonal "
            "mass, no GLM family was recognized, X fails the kernel's size "
            "gate, or the run is on the CPU); the engine integrated with a "
            "loop of value+grad calls.", stacklevel=2,
        )

    # -- constrain + collect -----------------------------------------------
    names_out = list(comp.continuous_latent_names)
    if collect_deterministic:
        names_out += [v.name for v in comp.order
                      if isinstance(v, DeterministicVariable) and v.parents]
    c, s = zs.shape[0], zs.shape[1]

    given_c = given
    if enumerate_discrete:
        # the discrete latents are not in the chain state: pinned to zeros,
        # so that the constrain walk and their deterministic descendants
        # stay defined (JAX mcmc.py:962-969)
        given_c = dict(given or {})
        for n in comp.discrete_latent_names:
            if n not in given_c:
                given_c[n] = torch.zeros(comp.shapes[n], dtype=torch.int64, device=dev)

    def one(zf):
        vals = comp.constrain(params, unravel(zf), given_c)
        return {n: vals[n] for n in names_out}

    with torch.no_grad():
        flat_vals = torch.func.vmap(one)(zs.reshape(c * s, dim))
    samples = {k: v.reshape((c, s) + tuple(v.shape[1:])) for k, v in flat_vals.items()}

    if tr is not None:
        tr.close(stage)
        stage = tr.open("sample.diagnostics")
    diagnostics: Dict[str, Any] = {
        "num_divergences": int(stats["diverging"].sum()),
        "mean_accept_prob": float(stats["accept_prob"].mean()),
        "step_size": info["step_size"],
        "inv_mass": info["inv_mass"],
        "sampler_seconds": sampler_seconds,
        **{k: info[k] for k in ("trajectory_length", "warmup_leapfrog", "chain_leapfrog",
                                "sampling_seconds") if k in info},
        "total_leapfrog_steps": int(stats["num_steps"].sum()),
        "value_and_grad_calls": vg.calls,
        "host_syncs": info["host_syncs"],
        "fused_family": fam_name,
        "fused_dtype": ("bf16" if bf16_active else "f32") if fam_name else None,
        "fused_leapfrog": k5_ran,
        # the autodiff value+grad replayed a CUDA graph (None: not autodiff)
        "value_and_grad_graphed": bool(value_and_grad_fn.graphs) if graphed else None,
        # graphs this call captured, and their seconds (0 when it replayed
        # the graphs of an earlier call on the same model and data)
        "value_and_grad_captures": len(value_and_grad_fn.graphs) - graphs0 if graphed else None,
        "value_and_grad_capture_seconds": (value_and_grad_fn.capture_seconds - capture0
                                           if graphed else None),
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
    if stage_a is not None:
        diagnostics["dense_stage_a"] = stage_a
    # checkpointable sampler state: feed back via sample(resume_state=...)
    resume = {"z": zs[:, -1], "step_size": info["step_size"], "inv_mass": info["inv_mass"]}
    if "trajectory_length" in info:  # ChEES: the adapted length resumes too
        resume["trajectory_length"] = info["trajectory_length"]
    if dense_ckpt is not None:
        resume.update(dense_ckpt)
    diagnostics["resume_state"] = resume
    if tr is not None:
        tr.close(stage)
    return MCMCResult(samples, stats, diagnostics)
