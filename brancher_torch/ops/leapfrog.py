"""Fused leapfrog: a whole trajectory of a GLM potential in one launch.

Counterpart of ``brancher_tpu/ops/pallas_leapfrog.py``.  The chain-batched
HMC and ChEES engines take an integrator
``leapfrog(z, r, grad, eps, inv_mass, n_steps) -> (z1, r1, val1, grad1)``;
NUTS cannot use one (it needs the tree's bookkeeping between steps).

  * ``reference_leapfrog(vg)``: a Python loop of any value+grad.  It reads
    ``n_steps`` on the host (one sync when it is a device tensor).  It is
    the CPU path, and the path on the card when the size gate refuses.
    Over the family's plain value+grad, ``reference_leapfrog(data.plain)``
    is K5's plain version.
  * ``build_fused_leapfrog``: the wrapper of kernel K5
    (``csrc/leapfrog.cu``), or None when the data fail the size gate.  The
    kernel reads ``eps`` and ``n_steps`` from device memory, so a
    transition on the card needs no host sync.

Size gate.  K5 copies the whole design matrix into each block's shared
memory and keeps it there for the whole trajectory, so X (rows padded to
an odd stride, ``d | 1`` floats) plus the state of one chain (z, r and g,
3 D floats, and 32 residuals) must fit in the shared memory one block may
opt in to: 232,448 bytes on an H100 (read from the device when there is
one).  That admits about 1,700 rows at D=32; the floor shape (N=1000,
D=32, 132 KB) and the conjugate shape (N=20, D=1) pass, the MXU-scale GLM
(N=131072, D=1024) does not and takes the loop of K1.  The TPU kernel's
6 MB VMEM budget does not carry over.

Plan.  ``plan_leapfrog`` (pure) lays out one launch in what X leaves of
the block's shared memory: the chains per block (G; about C over the
number of multiprocessors, so that one wave holds every chain), the warps
(up to 16), the rows of a tile, the row slices of the second product and
whether r and g stay in shared memory.  Every shape the gate admits has a
plan: at worst one chain and one warp, which needs no more than the gate's
bytes.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..inference.hmc import loop_leapfrog
from .glm import FusedFamily, build_glm_data

Tensor = torch.Tensor

# the shared memory one block may opt in to on an H100 (cudaDevAttr
# MaxSharedMemoryPerBlockOptin); the device's own figure is used when known
SMEM_PER_BLOCK_OPTIN = 232448
H100_SMS = 132
# the chains per block csrc/leapfrog.cu is built for, widest first, and its
# most warps per block (__launch_bounds__)
K5_CHAINS_PER_BLOCK = (8, 4, 2, 1)
K5_MAX_WARPS = 16


def leapfrog_smem_bytes(n: int, d: int, warps: int) -> int:
    """The size gate's bytes: X with rows padded to an odd stride, and per
    chain z, r, g [D] and 32 residuals (the one-warp-per-chain block of the
    first K5; ``leapfrog_fits`` asks for one chain)."""
    return 4 * (n * (d | 1) + warps * (3 * d + 32))


def leapfrog_fits(n: int, d: int, smem_limit: int = SMEM_PER_BLOCK_OPTIN) -> bool:
    """K5's size gate: X and one chain's state fit in one block."""
    return leapfrog_smem_bytes(n, d, 1) <= smem_limit


def _r4(v: int) -> int:
    return -(-v // 4) * 4


def leapfrog_layout_floats(n: int, d: int, chains: int, warps: int, rows_per_tile: int,
                           row_slices: int, state_in_smem: bool) -> int:
    """Floats of one K5 block's shared memory, as ``csrc/leapfrog.cu``'s
    ``layout`` lays it out: z [G][D'] and the residuals [G][T'] (D', T'
    rounded up to 4), the partial gradients [S][G][D] when S > 1, r and g
    [G][D] when they stay in shared memory, the reductions [W G + 2 G],
    and X [N][D | 1]."""
    g = chains
    return (g * _r4(d) + g * _r4(rows_per_tile)
            + (_r4(row_slices * g * d) if row_slices > 1 else 0)
            + (2 * _r4(g * d) if state_in_smem else 0)
            + _r4(warps * g + 2 * g) + n * (d | 1))


class LeapfrogPlan(NamedTuple):
    """One K5 launch over C chains (``plan_leapfrog``)."""

    chains: int  # G, chains per block: block b takes chains [b G, min((b + 1) G, C))
    warps: int  # warps per block
    rows_per_tile: int  # T, a multiple of 4: rows of X per product-1/product-2 round
    row_slices: int  # S, row slices of a tile in product 2
    state_in_smem: bool  # r and g in shared memory (else in the outputs)
    smem_bytes: int  # the block's dynamic shared memory
    blocks: int


def plan_leapfrog(c: int, n: int, d: int, smem_limit: int = SMEM_PER_BLOCK_OPTIN,
                  sms: int = H100_SMS) -> LeapfrogPlan:
    """K5's launch over z [C, D] and X [N, D] on a card with ``sms``
    multiprocessors and ``smem_limit`` bytes of shared memory per block.

    G is the widest of ``K5_CHAINS_PER_BLOCK`` not above C / sms (rounded
    up), so that one wave of blocks holds every chain; the warps start at
    one for every 64 rows (product 1 takes two rows a thread) or every 32
    columns, at most ``K5_MAX_WARPS``; product 2 cuts a tile's rows into
    as many slices as the warps cover column chunks.  The tile takes the
    rows that the rest leaves room for, and must give every warp rows
    (one warp: any tile); failing that, r and g move to the outputs, then
    the warps, then G shrink.  Raises when X fails the size gate."""
    if not leapfrog_fits(n, d, smem_limit):
        raise ValueError(f"K5: X [{n}, {d}] fails the size gate ({smem_limit} bytes)")
    budget = smem_limit // 4
    per_sm = -(-c // sms)
    chunks = -(-d // 32)
    top = min(K5_MAX_WARPS, max(1, -(-n // 64), chunks))
    for g in K5_CHAINS_PER_BLOCK:
        if g > per_sm and g > 1:
            continue
        for w in range(top, 0, -1):
            s = max(1, w // chunks)
            for state in (True, False):
                fixed = leapfrog_layout_floats(n, d, g, w, 0, s, state)
                t = min(_r4(n), (budget - fixed) // g // 4 * 4)
                if t >= (min(_r4(n), 64 * w) if w > 1 else 4):
                    floats = leapfrog_layout_floats(n, d, g, w, t, s, state)
                    return LeapfrogPlan(g, w, t, s, state, 4 * floats, -(-c // g))
    raise AssertionError("unreachable: one chain and one warp fit whatever the gate admits")


_CAPS: Dict[Tuple[str, Optional[int]], Tuple[int, int]] = {}


def device_caps(device: torch.device) -> Tuple[int, int]:
    """(shared memory a block may opt in to, multiprocessors) of a device,
    read once; an H100's for a device that is not CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return SMEM_PER_BLOCK_OPTIN, H100_SMS
    key = (device.type, device.index if device.index is not None else torch.cuda.current_device())
    if key not in _CAPS:
        props = torch.cuda.get_device_properties(key[1])
        _CAPS[key] = (int(getattr(props, "shared_memory_per_block_optin", SMEM_PER_BLOCK_OPTIN)),
                      int(props.multi_processor_count))
    return _CAPS[key]


def reference_leapfrog(value_and_grad_fn):
    """Loop-of-value+grad integrator with the fused one's signature."""

    def leapfrog(z, r, grad, eps, inv_mass, n_steps):
        z1, r1, val1, grad1, _ = loop_leapfrog(value_and_grad_fn, z, r, grad, eps,
                                               inv_mass, int(n_steps))
        return z1, r1, val1, grad1

    leapfrog.host_syncs_per_call = 1  # int(n_steps) of a device tensor
    return leapfrog


class LeapfrogKernel:
    """Wrapper of ``csrc/leapfrog.cu`` (both GLM families, f32).

    ``launches`` counts the calls that launched the kernel: one per
    trajectory, whatever its number of steps.
    """

    name = "leapfrog_f32"
    source = "brancher_torch/csrc/leapfrog.cu"
    replaces = "brancher_tpu/ops/pallas_leapfrog.py:73 _leap_kernel"
    symbols = {"bernoulli_logit": "leapfrog_bernoulli_f32", "normal_learned": "leapfrog_normal_f32"}

    def __init__(self):
        self.launches = 0
        self._fns = {}

    def _c_function(self, family: str):
        fn = self._fns.get(family)
        if fn is None:
            from .cuda_build import load_library

            fn = getattr(load_library("leapfrog"), self.symbols[family])
            p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
            fn.argtypes = [p] * 12 + [f, f, f] + [p] * 4 + [i] * 9 + [ctypes.c_size_t, p]
            fn.restype = ctypes.c_int
            self._fns[family] = fn
        return fn

    @staticmethod
    def _check(data: FusedFamily, z, r, grad, inv_mass):
        if data.x.dtype != torch.float32 or not data.x.is_contiguous():
            raise TypeError("the fused leapfrog takes a contiguous f32 design matrix")
        c, d = z.shape
        for nm, t in (("z", z), ("r", r), ("grad", grad)):
            if (t.dtype != torch.float32 or tuple(t.shape) != (c, d)
                    or not t.is_contiguous() or t.device != data.x.device):
                raise TypeError(f"leapfrog: {nm} must be a contiguous [{c}, {d}] float32 "
                                f"tensor on {data.x.device}")
        if tuple(inv_mass.shape) != (d,):
            raise ValueError("leapfrog: inv_mass must be a diagonal [D] tensor")
        if data.x.shape[1] != d or c == 0:
            raise ValueError(f"leapfrog: z is [{c}, {d}], X is {tuple(data.x.shape)}")

    def __call__(self, data: FusedFamily, z, r, grad, eps, inv_mass, n_steps,
                 plan: Optional[LeapfrogPlan] = None):
        """One trajectory; ``plan`` is ``plan_leapfrog``'s for these shapes
        on z's device (made here when not given)."""
        if z.device.type == "cpu":
            return reference_leapfrog(data.plain)(z, r, grad, eps, inv_mass, n_steps)
        if z.device.type != "cuda":
            raise RuntimeError(f"{self.name} runs on CUDA tensors, got {z.device}")
        dev = z.device
        im = torch.as_tensor(inv_mass, device=dev).to(torch.float32).contiguous()
        self._check(data, z, r, grad, im)
        # step size and count stay on the device: no host sync
        eps_t = (eps.to(device=dev, dtype=torch.float32).reshape(()) if isinstance(eps, Tensor)
                 else torch.full((), float(eps), dtype=torch.float32, device=dev))
        n_t = (n_steps.to(device=dev, dtype=torch.int32).reshape(()) if isinstance(n_steps, Tensor)
               else torch.full((), int(n_steps), dtype=torch.int32, device=dev))
        c, d = z.shape
        n = data.x.shape[0]
        if plan is None:
            plan = plan_leapfrog(c, n, d, *device_caps(dev))
        z1, r1, g1 = torch.empty_like(z), torch.empty_like(z), torch.empty_like(z)
        val = torch.empty((c,), dtype=torch.float32, device=dev)
        u_ptr = data.u.data_ptr() if data.u is not None else None
        fn = self._c_function(data.family)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(z.data_ptr(), r.data_ptr(), grad.data_ptr(), data.x.data_ptr(),
                     data.y.data_ptr(), data.b.data_ptr(), data.prior_mean.data_ptr(),
                     data.prior_inv_var.data_ptr(), im.data_ptr(), u_ptr,
                     eps_t.data_ptr(), n_t.data_ptr(), float(data.c0),
                     float(data.ll_scale), float(n), z1.data_ptr(), r1.data_ptr(),
                     val.data_ptr(), g1.data_ptr(), c, n, d, d | 1, plan.chains, plan.warps,
                     plan.rows_per_tile, plan.row_slices, int(plan.state_in_smem),
                     plan.smem_bytes, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        return z1, r1, val, g1


LEAPFROG = LeapfrogKernel()


class FusedLeapfrog:
    """K5 over data prepared once: ``(z, r, grad, eps, inv_mass, n_steps)
    -> (z1, r1, val1, grad1)``, the kernel on CUDA, its plain version on
    the CPU.  Keeps K5's plan per (device, C), so a call reads no device
    properties."""

    host_syncs_per_call = 0

    def __init__(self, data: FusedFamily):
        self.data = data
        self._plans: Dict[Tuple[torch.device, int], LeapfrogPlan] = {}

    def plan(self, z: Tensor) -> LeapfrogPlan:
        """K5's plan for chains z [C, D] on z's device."""
        key = (z.device, z.shape[0])
        if key not in self._plans:
            n, d = self.data.x.shape
            self._plans[key] = plan_leapfrog(z.shape[0], n, d, *device_caps(z.device))
        return self._plans[key]

    @property
    def uses_kernel(self) -> bool:
        """A call launches K5 (the data are on a CUDA device)."""
        return self.data.x.device.type == "cuda"

    def __call__(self, z, r, grad, eps, inv_mass, n_steps):
        plan = self.plan(z) if z.device.type == "cuda" else None
        return LEAPFROG(self.data, z, r, grad, eps, inv_mass, n_steps, plan=plan)


def build_fused_leapfrog(family, x, y, b, prior_mean, prior_inv_var, u=None, c0=0.0,
                         ll_scale=1.0, device=None) -> Optional[FusedLeapfrog]:
    """The K5 integrator over the data, moved once to ``device`` (default
    ``config.device``), or None when X fails the size gate (module
    docstring)."""
    data = build_glm_data(family, x, y, b, prior_mean, prior_inv_var, u=u, c0=c0,
                          ll_scale=ll_scale, dtype="f32", device=device, align_x=False)
    n, d = data.x.shape
    if not leapfrog_fits(n, d, device_caps(data.x.device)[0]):
        return None
    return FusedLeapfrog(data)


def leapfrog_flops(c: int, n: int, d: int, n_steps: int) -> int:
    """Operations of one trajectory: two products through X per step."""
    return 4 * c * n * d * n_steps


def leapfrog_bytes(c: int, n: int, d: int, family: str) -> int:
    """Least bytes one trajectory moves: X, y, b, the prior, the inverse
    mass (and u) read once, z, r, g read and written once, val written."""
    d_vectors = 4 if family == "normal_learned" else 3
    return n * d * 4 + 2 * n * 4 + d_vectors * d * 4 + 2 * 3 * c * d * 4 + c * 4


__all__ = [
    "reference_leapfrog", "build_fused_leapfrog", "FusedLeapfrog",
    "LeapfrogKernel", "LEAPFROG", "leapfrog_fits", "leapfrog_smem_bytes",
    "LeapfrogPlan", "plan_leapfrog", "leapfrog_layout_floats", "device_caps",
    "leapfrog_flops", "leapfrog_bytes", "SMEM_PER_BLOCK_OPTIN", "K5_CHAINS_PER_BLOCK",
    "K5_MAX_WARPS",
]
