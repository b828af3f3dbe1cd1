"""Hamiltonian Monte Carlo kernel.

Counterpart of ``brancher_tpu/inference/hmc.py``: ``ChainState``,
``init_chain_state``, ``kinetic_energy``, the per-chain ``leapfrog``, the
``HMC`` settings with ``make_step`` (lines 23-108) and ``hmc_sample``
(line 111).  ``sample(chain_method="vectorized")`` runs HMC with the
chain-batched engine ``ops.batched_hmc.hmc_batched``;
``chain_method="vmap"`` runs ``make_step``.

JAX's per-chain step works on one chain and is ``vmap``ped;
``torch.func.vmap`` refuses data-dependent loops and random draws, so the
port's step takes the whole [C, d] block and gives each chain what its own
step would: a chain's jittered step count is its own, and a chain past it
keeps its state while the others integrate on (JAX's ``vmap`` of a
``fori_loop`` with a per-chain bound is that masked batch).  Its draws
come from a source with the methods of ``TorchChainRandom``, so a test
can feed JAX's per-chain numbers.  It launches no kernel: its value and
gradient are the vmapped autodiff of the potential, as in JAX.

Also here, shared by the chain-batched HMC and ChEES engines: their
injectable randomness source (``TorchHMCRandom``) and the loop
integrator (``loop_leapfrog``).
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from .. import metrics as _metrics

Tensor = torch.Tensor
VG = Callable[[Tensor], Tuple[Tensor, Tensor]]


def autodiff_value_and_grad(potential_fn) -> "GraphedValueAndGrad":
    """[C, d] -> (log density [C], its gradient [C, d]) by autograd of
    ``potential_fn`` ([d] -> -log density) vmapped over the chains.

    The chains are independent, so the gradient of the summed batch is each
    chain's own: one ``torch.func.vmap`` forward and one backward through
    the autograd engine give the numbers of ``vmap(grad_and_value(...))``
    at about two thirds of its host cost a call.  On CUDA the call is
    captured once per input shape in a CUDA graph and replayed
    (``GraphedValueAndGrad``; its ``fn`` is the eager call): the same
    kernels on the same numbers, without the host's dispatch of each op
    every call."""
    batched = torch.func.vmap(lambda zf: -potential_fn(zf))

    def vg(z):
        with torch.enable_grad():
            zg = z.detach().requires_grad_(True)
            v = batched(zg)
            g, = torch.autograd.grad(v.sum(), zg, allow_unused=True, materialize_grads=True)
        return v.detach(), g

    return GraphedValueAndGrad(vg)


class GraphedValueAndGrad:
    """A value+grad function replayed from a CUDA graph on CUDA inputs.

    The first call at a shape runs ``fn`` twice on a side stream (as
    capture requires), captures one call into a graph over a static input
    buffer, and replays it; later calls copy z into the buffer, replay, and
    return copies of the static outputs.  A function the card cannot
    capture (one that waits on the card, for example) runs eagerly at that
    shape from then on (``eager_shapes``).  Inputs on the CPU run eagerly.
    ``capture_seconds`` sums the wall time of the captures, warm-up calls
    included, each ended by a device synchronize; with ``metrics.tracing()``
    on, each capture is a ``vg.capture`` span of that interval."""

    def __init__(self, fn: VG):
        self.fn = fn
        self.graphs = {}
        self.eager_shapes = set()
        self.capture_seconds = 0.0

    def __call__(self, z):
        if z.device.type != "cuda":
            return self.fn(z)
        key = (tuple(z.shape), z.dtype, z.device)
        if key in self.eager_shapes:
            return self.fn(z)
        entry = self.graphs.get(key)
        if entry is None:
            t0 = time.perf_counter_ns()
            entry = self._capture(z, key)
            torch.cuda.synchronize(z.device)
            t1 = time.perf_counter_ns()
            self.capture_seconds += (t1 - t0) * 1e-9
            tr = _metrics._tracer
            if tr is not None:
                tr.span("vg.capture", t0, t1)
            if entry is None:
                return self.fn(z)
        graph, static_z, v, g = entry
        static_z.copy_(z)
        graph.replay()
        return v.clone(), g.clone()

    def _capture(self, z, key):
        static_z = z.detach().clone()
        side = torch.cuda.Stream(device=z.device)
        side.wait_stream(torch.cuda.current_stream(z.device))
        try:
            with torch.cuda.stream(side):
                for _ in range(2):
                    self.fn(static_z)
            torch.cuda.current_stream(z.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's CUDA calls (a process group's
            # watchdog querying its collectives' events) do not break it
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                v, g = self.fn(static_z)
        except RuntimeError:
            torch.cuda.synchronize(z.device)
            self.eager_shapes.add(key)
            return None
        self.graphs[key] = (graph, static_z, v, g)
        return self.graphs[key]


class ChainState(NamedTuple):
    z: Tensor  # [C, d] flat unconstrained positions
    pe: Tensor  # [C] potential energy at z
    grad: Tensor  # [C, d] d pe / dz


def init_chain_state(value_and_grad_fn: VG, z: Tensor) -> ChainState:
    """The state at z from a [C, d] -> (log density, gradient) function."""
    val, grad = value_and_grad_fn(z)
    return ChainState(z, -val, -grad)


def kinetic_energy(r: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    """1/2 r^T M^-1 r for a diagonal inverse mass, over the last axis."""
    return 0.5 * torch.sum(r * r * inv_mass, dim=-1)


def _column(step_size: Tensor) -> Tensor:
    """A per-chain step [C] as a column; a shared 0-d step as it is."""
    return step_size[:, None] if step_size.dim() == 1 else step_size


def leapfrog(value_and_grad_fn: VG, z: Tensor, r: Tensor, grad: Tensor, step_size: Tensor,
             inv_mass: Tensor, num_steps: Union[int, Tensor]):
    """``num_steps`` velocity-Verlet steps of each chain on the potential
    energy: an int, or a [C] tensor (one host sync for its maximum), past
    which a chain keeps its state.  ``grad`` is d pe / dz; returns (z, r,
    pe, grad), with pe 0 where no step ran, as in JAX."""
    st = _column(torch.as_tensor(step_size, dtype=z.dtype, device=z.device))
    pe = torch.zeros(z.shape[:1], dtype=z.dtype, device=z.device)
    per_chain = isinstance(num_steps, Tensor)
    for i in range(int(num_steps.max()) if per_chain else num_steps):
        r1 = r - 0.5 * st * grad
        z1 = z + st * inv_mass * r1
        val, g = value_and_grad_fn(z1)
        pe1, grad1 = -val, -g
        r1 = r1 - 0.5 * st * grad1
        if not per_chain:
            z, r, pe, grad = z1, r1, pe1, grad1
            continue
        on = i < num_steps
        z, r, grad = (torch.where(on[:, None], a, b) for a, b in ((z1, z), (r1, r), (grad1, grad)))
        pe = torch.where(on, pe1, pe)
    return z, r, pe, grad


class TorchChainRandom:
    """The randomness of the per-chain steps (``HMC.make_step``,
    ``NUTS.make_step``), drawn from a torch.Generator: every chain its own
    numbers.

    ``momentum(z)``: standard normals shaped like z; ``accept(c, like)``:
    uniforms [C]; ``num_steps(high, c, device)``: ints [C], uniform in
    [1, high]; ``tree(depth, c, like)``: for the doubling at ``depth``, (go
    right [C] bool, merge uniforms [C]); ``leaf(depth, i, c, like)``: the
    swap uniforms [C] of leaf i of that doubling's subtree.  JAX draws the
    direction as ``bernoulli(0.5)``, a uniform below one half.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _uniform(self, c: int, like: Tensor) -> Tensor:
        return torch.rand((c,), generator=self.generator, device=like.device, dtype=like.dtype)

    def momentum(self, z: Tensor) -> Tensor:
        return torch.randn(z.shape, generator=self.generator, device=z.device, dtype=z.dtype)

    def accept(self, c: int, like: Tensor) -> Tensor:
        return self._uniform(c, like)

    def num_steps(self, high: int, c: int, device) -> Tensor:
        return torch.randint(1, high + 1, (c,), generator=self.generator, device=device)

    def tree(self, depth: int, c: int, like: Tensor) -> Tuple[Tensor, Tensor]:
        u = torch.rand((2, c), generator=self.generator, device=like.device, dtype=like.dtype)
        return u[0] < 0.5, u[1]

    def leaf(self, depth: int, i: int, c: int, like: Tensor) -> Tensor:
        return self._uniform(c, like)


class TorchHMCRandom:
    """The randomness of HMC/ChEES transitions, from a torch.Generator.

    ``momentum(z)``: standard normals shaped like z; ``accept(c, like)``:
    uniforms [C]; ``num_steps(high, device)``: a 0-d int tensor, uniform
    in [1, high], drawn on the device (no host sync).
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def momentum(self, z: Tensor) -> Tensor:
        return torch.randn(z.shape, generator=self.generator, device=z.device, dtype=z.dtype)

    def accept(self, c: int, like: Tensor) -> Tensor:
        return torch.rand((c,), generator=self.generator, device=like.device, dtype=like.dtype)

    def num_steps(self, high: int, device) -> Tensor:
        return torch.randint(1, high + 1, (), generator=self.generator, device=device)


def loop_leapfrog(value_and_grad_fn: VG, z, r, grad, eps, inv_mass, n_steps: int,
                  h0: Optional[Tensor] = None, kinetic=kinetic_energy,
                  velocity=None, max_delta_energy: float = 1000.0):
    """``n_steps`` velocity-Verlet steps of ``value_and_grad_fn`` (a LOG
    density).  With ``h0`` the energy error is checked after every step;
    returns (z, r, val, grad, diverging [C]).  ``val`` is 0 when no step
    runs, as in the JAX loop."""
    velocity = velocity or (lambda rr: rr * inv_mass[None, :])
    val = torch.zeros((z.shape[0],), dtype=z.dtype, device=z.device)
    div = torch.zeros((z.shape[0],), dtype=torch.bool, device=z.device)
    for _ in range(n_steps):
        r = r + 0.5 * eps * grad
        z = z + eps * velocity(r)
        val, grad = value_and_grad_fn(z)
        r = r + 0.5 * eps * grad
        if h0 is not None:
            h = -val + kinetic(r, inv_mass)
            div = div | ~(h - h0 < max_delta_energy)  # NaN counts
    return z, r, val, grad, div


class HMC:
    """HMC kernel config (plugs into mcmc.sample).

    num_integration_steps: leapfrog steps per transition, or the upper
    end of the uniform draw in [1, num_integration_steps] when
    ``jitter_steps`` is set.
    """

    def __init__(self, num_integration_steps: int = 32, jitter_steps: bool = True,
                 target_accept: float = 0.8, max_delta_energy: float = 1000.0):
        self.num_integration_steps = num_integration_steps
        self.jitter_steps = jitter_steps
        self.target_accept = target_accept
        self.max_delta_energy = max_delta_energy

    def make_step(self, potential_fn: Callable, value_and_grad_fn: Optional[VG] = None):
        """The per-chain transition ``step(rng, state, step_size, inv_mass)
        -> (state, stats)`` over a [C, d] block.  ``value_and_grad_fn``
        ([C, d] -> log density, gradient) defaults to the vmapped autodiff
        of ``potential_fn``; ``rng`` has ``TorchChainRandom``'s methods."""
        vg = value_and_grad_fn or autodiff_value_and_grad(potential_fn)
        length, jitter, max_delta = self.num_integration_steps, self.jitter_steps, self.max_delta_energy

        def step(rng, state: ChainState, step_size: Tensor, inv_mass: Tensor):
            z = state.z
            c = z.shape[0]
            r0 = rng.momentum(z) / torch.sqrt(inv_mass)
            h0 = state.pe + kinetic_energy(r0, inv_mass)
            n_steps = rng.num_steps(length, c, z.device) if jitter else length
            z1, r1, pe1, grad1 = leapfrog(vg, z, r0, state.grad, step_size, inv_mass, n_steps)
            h1 = pe1 + kinetic_energy(r1, inv_mass)
            delta = h0 - h1
            delta = torch.where(torch.isnan(delta), -torch.inf, delta)
            accept_prob = torch.clamp(torch.exp(torch.clamp(delta, max=0.0)), max=1.0)
            accept = rng.accept(c, state.pe) < accept_prob
            new = ChainState(*(torch.where(accept[:, None] if a.dim() == 2 else accept, a, b)
                               for a, b in zip((z1, pe1, grad1), state)))
            steps = (n_steps if jitter else torch.full((c,), length, device=z.device)).to(torch.int32)
            stats = {"accept_prob": accept_prob, "diverging": -delta > max_delta,
                     "energy": h1, "num_steps": steps,
                     "host_syncs": int(jitter)}  # the step count's maximum
            return new, stats

        return step


def hmc_sample(model, **kwargs):
    """Convenience: run HMC on a ProbabilisticModel (see mcmc.sample)."""
    from .mcmc import sample

    kernel = HMC(**{k: kwargs.pop(k) for k in list(kwargs)
                    if k in ("num_integration_steps", "jitter_steps", "target_accept")})
    return sample(model, kernel=kernel, **kwargs)
