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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..inference.hmc import loop_leapfrog
from .glm import FusedFamily, build_glm_data

Tensor = torch.Tensor

# the shared memory one block may opt in to on an H100 (cudaDevAttr
# MaxSharedMemoryPerBlockOptin); the device's own figure is used when known
SMEM_PER_BLOCK_OPTIN = 232448
MAX_WARPS_PER_BLOCK = 32


def leapfrog_smem_bytes(n: int, d: int, warps: int) -> int:
    """Shared memory of one K5 block: X with rows padded to an odd stride,
    and per warp (one chain) z, r, g [D] and 32 residuals."""
    return 4 * (n * (d | 1) + warps * (3 * d + 32))


def leapfrog_fits(n: int, d: int, smem_limit: int = SMEM_PER_BLOCK_OPTIN) -> bool:
    """K5's size gate: X and one chain's state fit in one block."""
    return leapfrog_smem_bytes(n, d, 1) <= smem_limit


def _smem_limit(device: torch.device) -> int:
    if device.type != "cuda":
        return SMEM_PER_BLOCK_OPTIN
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", SMEM_PER_BLOCK_OPTIN))


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
            fn.argtypes = [p] * 12 + [f, f, f] + [p] * 4 + [i] * 5 + [ctypes.c_size_t, p]
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

    def __call__(self, data: FusedFamily, z, r, grad, eps, inv_mass, n_steps):
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
        limit = _smem_limit(dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        warps = max(1, min(MAX_WARPS_PER_BLOCK, -(-c // sms)))  # one wave of blocks
        while warps > 1 and leapfrog_smem_bytes(n, d, warps) > limit:
            warps -= 1
        smem = leapfrog_smem_bytes(n, d, warps)
        if smem > limit:
            raise ValueError(f"{self.name}: X [{n}, {d}] does not fit in shared memory")
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
                     val.data_ptr(), g1.data_ptr(), c, n, d, d | 1, warps, smem, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        return z1, r1, val, g1


LEAPFROG = LeapfrogKernel()


class FusedLeapfrog:
    """K5 over data prepared once: ``(z, r, grad, eps, inv_mass, n_steps)
    -> (z1, r1, val1, grad1)``, the kernel on CUDA, its plain version on
    the CPU."""

    host_syncs_per_call = 0

    def __init__(self, data: FusedFamily):
        self.data = data

    @property
    def uses_kernel(self) -> bool:
        """A call launches K5 (the data are on a CUDA device)."""
        return self.data.x.device.type == "cuda"

    def __call__(self, z, r, grad, eps, inv_mass, n_steps):
        return LEAPFROG(self.data, z, r, grad, eps, inv_mass, n_steps)


def build_fused_leapfrog(family, x, y, b, prior_mean, prior_inv_var, u=None, c0=0.0,
                         ll_scale=1.0, device=None) -> Optional[FusedLeapfrog]:
    """The K5 integrator over the data, moved once to ``device`` (default
    ``config.device``), or None when X fails the size gate (module
    docstring)."""
    data = build_glm_data(family, x, y, b, prior_mean, prior_inv_var, u=u, c0=c0,
                          ll_scale=ll_scale, dtype="f32", device=device, align_x=False)
    n, d = data.x.shape
    if not leapfrog_fits(n, d, _smem_limit(data.x.device)):
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
    "leapfrog_flops", "leapfrog_bytes", "SMEM_PER_BLOCK_OPTIN",
]
