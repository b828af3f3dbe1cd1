"""Fused GLM value+grad: plain versions, CUDA kernel wrappers, recognizer.

Counterpart of ``brancher_tpu/ops/pallas_glm.py``.  Two families cover
the dense likelihoods of the model zoo:

  * ``bernoulli_logit``  y_n ~ Bernoulli(sigmoid(x_n.z + b_n))
  * ``normal_learned``   y_n ~ N(x_n.z + b_n, exp(u.z + c0))

For each family and design-matrix type (f32, bf16) there is a plain
PyTorch version (``*_vg_reference*``) and a kernel written by hand in CUDA.
The Bernoulli pair K1 (f32) and K2 (bf16) has its own design for Hopper
(``csrc/glm_bernoulli_sm90.cuh``: passes planned by ``plan_bernoulli``,
K2 on the tensor cores through ``wgmma`` fed by TMA); the Normal pair K3/K4
and K6 (``ops/logreg.py``) share the template of ``csrc/glm_vg.cu``.  The
wrappers (``GlmKernel``, ``BernoulliKernel``) take a tensor on the CPU to
the plain version and a tensor on a CUDA device to the kernel; there is no
fallback from the kernel to the plain version.

``recognize_fused_family`` numerically probes a compiled model: it checks
that the z-space prior is a diagonal Gaussian, extracts the affine design
of the observed likelihood's parameters, and self-checks the assembled
potential against the autodiff log-density before trusting it.  It
probes on the model's device.  The Categorical and AutoRegressive
branches of the JAX recognizer are still to port (ROADMAP queue 1,
items 13 and 14): those models are not recognized yet.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..distributions import Bernoulli, Normal, softplus

Tensor = torch.Tensor


# ======================================================================
# Plain versions (CPU path, tests, and the yardstick on the card)
# ======================================================================

def _bf16_matmul(a: Tensor, b: Tensor) -> Tensor:
    """a @ b with bf16 multiplies and f32 accumulation: both operands are
    rounded to bf16 and multiplied in f32, where the product of two bf16
    values is exact (CPU bf16 matmul would round the result to bf16)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def bernoulli_vg_reference(z, x, y, b, prior_mean, prior_inv_var, ll_scale=1.0):
    """z [C,D] -> (val [C], grad [C,D]).  logits = z@x.T + b."""
    logits = z @ x.T + b[None, :]
    ll = torch.sum(y[None, :] * logits - softplus(logits), dim=-1)
    dz = z - prior_mean[None, :]
    val = ll_scale * ll - 0.5 * torch.sum(dz * dz * prior_inv_var[None, :], -1)
    resid = y[None, :] - torch.sigmoid(logits)
    grad = ll_scale * (resid @ x) - dz * prior_inv_var[None, :]
    return val, grad


def bernoulli_vg_reference_bf16(z, x16, y, b, prior_mean, prior_inv_var, ll_scale=1.0):
    """bernoulli_vg_reference with bf16 multiplies / f32 accumulates.
    ``x16`` is the design matrix cast to bf16 once, at build time."""
    logits = _bf16_matmul(z, x16.T) + b[None, :]
    ll = torch.sum(y[None, :] * logits - softplus(logits), dim=-1)
    dz = z - prior_mean[None, :]
    val = ll_scale * ll - 0.5 * torch.sum(dz * dz * prior_inv_var[None, :], -1)
    resid = y[None, :] - torch.sigmoid(logits)
    grad = ll_scale * _bf16_matmul(resid, x16) - dz * prior_inv_var[None, :]
    return val, grad


def normal_vg_reference(z, x, y, b, u, c0, prior_mean, prior_inv_var, ll_scale=1.0):
    """z [C,D] -> (val [C], grad [C,D]); resid = y - (z@x.T + b), log-noise
    s = z@u + c0, ll = -1/2 e^{-2s} ||resid||^2 - N s (+ const)."""
    n = y.shape[0]
    resid = y[None, :] - (z @ x.T + b[None, :])
    s = z @ u + c0
    e2 = torch.exp(-2.0 * s)
    rss = torch.sum(resid * resid, -1)
    dz = z - prior_mean[None, :]
    val = ll_scale * (-0.5 * e2 * rss - n * s) - 0.5 * torch.sum(
        dz * dz * prior_inv_var[None, :], -1)
    g_loc = e2[:, None] * (resid @ x)
    g_s = e2 * rss - n
    grad = ll_scale * (g_loc + g_s[:, None] * u[None, :]) - dz * prior_inv_var[None, :]
    return val, grad


def normal_vg_reference_bf16(z, x16, y, b, u, c0, prior_mean, prior_inv_var, ll_scale=1.0):
    """normal_vg_reference with bf16 multiplies / f32 accumulates; u.z is
    [D]-small and stays f32."""
    n = y.shape[0]
    loc = _bf16_matmul(z, x16.T) + b[None, :]
    resid = y[None, :] - loc
    s = z @ u + c0
    e2 = torch.exp(-2.0 * s)
    rss = torch.sum(resid * resid, -1)
    dz = z - prior_mean[None, :]
    val = ll_scale * (-0.5 * e2 * rss - n * s) - 0.5 * torch.sum(
        dz * dz * prior_inv_var[None, :], -1)
    g_loc = e2[:, None] * _bf16_matmul(resid, x16)
    g_s = e2 * rss - n
    grad = ll_scale * (g_loc + g_s[:, None] * u[None, :]) - dz * prior_inv_var[None, :]
    return val, grad


def bernoulli_residual_reference(z, data):
    """The plain version's f32 residual y - sigmoid(l) [C, N] before any
    bf16 rounding, for a Bernoulli FusedFamily (bf16 multiplies when X is
    bf16)."""
    x = data.x
    logits = (_bf16_matmul(z, x.T) if x.dtype == torch.bfloat16 else z @ x.T) + data.b[None, :]
    return data.y[None, :] - torch.sigmoid(logits)


def bernoulli_grad_given_residual(resid, z, data):
    """The plain version's gradient with the residual [C, N] given, its
    rounding included: ll_scale * resid @ X - (z - m) iv, in f32."""
    dz = z - data.prior_mean[None, :]
    return data.ll_scale * (resid.float() @ data.x.float()) - dz * data.prior_inv_var[None, :]


def bf16_rounding_flips(resid16, resid32):
    """Where a bf16 residual is not the round-to-nearest-even of the f32
    one: (flips, legal, tie_units).  ``legal`` marks the flips that are
    the other bf16 neighbour of the f32 value, one bf16 unit away;
    ``tie_units`` is each f32 value's distance from the midpoint between
    its two bf16 neighbours, in f32 units in the last place (the 16 bits
    that bf16 drops)."""
    r32 = resid32.float().contiguous()
    bits32 = r32.view(torch.int32)
    bits16 = resid16.float().contiguous().view(torch.int32)
    flips = resid16.float() != r32.to(torch.bfloat16).float()
    toward_zero = bits32 & ~0xFFFF
    legal = flips & ((bits16 == toward_zero) | (bits16 == toward_zero + 0x10000))
    return flips, legal, ((bits32 & 0xFFFF) - 0x8000).abs()


def _rel(got: Tensor, ref: Tensor) -> float:
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def bf16_residual_readings(g, resid, z, data, g_ref) -> Dict[str, float]:
    """What the checks of K2 (bf16 Bernoulli) read for a gradient ``g``
    that was computed from the residual ``resid`` [C, N], against the
    plain version's gradient ``g_ref`` on the bf16 ``data``.

    ``resid_flips`` counts the residuals that are not the bf16 rounding of
    the plain version's f32 residual; ``flips_legal`` says whether each is
    the other bf16 neighbour (a tie), and ``flip_tie_units_max`` how far the
    farthest lay from the rounding midpoint (``bf16_rounding_flips``).  A
    tie moves its chain's gradient by its bf16 unit times ll_scale times
    its row of X, so ``flip_allowance_rel`` is ll_scale times the largest
    sum over one chain's ties of that unit times the row's max|X|, over
    max(max|g_ref|, 1): 0 where no residual differs.  ``grad_max_rel`` is
    the raw error against ``g_ref`` and ``grad_given_resid_rel`` the error
    against the plain formula on ``resid``, both in that scale."""
    r32 = bernoulli_residual_reference(z, data)
    flips, legal, units = bf16_rounding_flips(resid, r32)
    n_flips = int(flips.sum())
    step = torch.where(legal, (resid.float() - r32.to(torch.bfloat16).float()).abs(), 0.0)
    x_row_max = data.x.float().abs().amax(1)
    scale = max(float(g_ref.abs().max()), 1.0)
    return {
        "resid_flips": n_flips, "flip_share": n_flips / resid.numel(),
        "flips_legal": bool(torch.equal(flips, legal)),
        "flip_tie_units_max": int(units[flips].max()) if n_flips else 0,
        "grad_max_rel": _rel(g, g_ref),
        "flip_allowance_rel": abs(data.ll_scale) * float((step @ x_row_max).max()) / scale,
        "grad_given_resid_rel": _rel(g, bernoulli_grad_given_residual(resid, z, data)),
    }


# ======================================================================
# Build-once data and the kernel wrappers
# ======================================================================

class FusedFamily(NamedTuple):
    """The data of one fused GLM potential.  The recognizer returns it with
    an f32 design matrix; ``build_glm_data`` prepares the copy a kernel
    reads (on its device, contiguous, X cast to bf16 for the bf16 kernels)."""

    family: str  # "bernoulli_logit" | "normal_learned"
    x: Tensor  # [N, D] float32 or bfloat16
    y: Tensor  # [N]
    b: Tensor  # [N]
    u: Optional[Tensor]  # [D] (normal_learned)
    c0: float
    prior_mean: Tensor  # [D]
    prior_inv_var: Tensor  # [D]
    ll_scale: float
    scratch: Optional["BernoulliScratch"] = None  # K1/K2's, as long as the data lives

    def value_and_grad(self, dtype: str = "f32") -> Callable[[Tensor], Tuple[Tensor, Tensor]]:
        """Batched fused potential fn(z [C,D]) -> (val [C], grad [C,D]) on
        the family's device: the hand-written kernel on CUDA, the plain
        version on the CPU.  dtype='bf16' samples a slightly perturbed
        density (bf16 multiplies, f32 accumulates)."""
        return build_glm_vg(
            self.family, self.x, self.y, self.b, self.prior_mean,
            self.prior_inv_var, u=self.u, c0=self.c0, ll_scale=self.ll_scale,
            dtype=dtype, device=self.x.device,
        )

    def leapfrog(self):
        """Multi-step integrator (z, r, grad, eps, inv_mass, n_steps) ->
        (z1, r1, val1, grad1) on the family's device: on CUDA the fused
        kernel K5 when X passes its size gate, else a loop of this
        family's value+grad kernel; on the CPU the loop of the plain
        version (``ops/leapfrog.py``)."""
        from .leapfrog import build_fused_leapfrog, reference_leapfrog

        if self.x.device.type == "cuda":
            lf = build_fused_leapfrog(
                self.family, self.x, self.y, self.b, self.prior_mean,
                self.prior_inv_var, u=self.u, c0=self.c0,
                ll_scale=self.ll_scale, device=self.x.device,
            )
            if lf is not None:
                return lf
        return reference_leapfrog(self.value_and_grad())

    def plain(self, z: Tensor) -> Tuple[Tensor, Tensor]:
        """The kernel's plain PyTorch version on the same data."""
        bf16 = self.x.dtype == torch.bfloat16
        common = (self.prior_mean, self.prior_inv_var, self.ll_scale)
        if self.family == "bernoulli_logit":
            fn = bernoulli_vg_reference_bf16 if bf16 else bernoulli_vg_reference
            return fn(z, self.x, self.y, self.b, *common)
        fn = normal_vg_reference_bf16 if bf16 else normal_vg_reference
        return fn(z, self.x, self.y, self.b, self.u, self.c0, *common)


class GlmKernel:
    """Wrapper of one instantiation of ``csrc/glm_vg.cu``.

    ``launches`` counts the calls that launched the kernel (one per
    value+grad evaluation; the two passes of a call count once).
    """

    source = "brancher_torch/csrc/glm_vg.cu"

    def __init__(self, name: str, family: str, x_dtype: torch.dtype,
                 symbol: str, replaces: str):
        self.name = name
        self.family = family
        self.x_dtype = x_dtype
        self.symbol = symbol
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        self._tiles = None  # (chains, rows) per block, read from the library

    def _c_function(self):
        if self._fn is None:
            p = ctypes.c_void_p
            self._fn, self._tiles = glm_vg_function(
                self.symbol, [p, p, p, p, p, p, p, ctypes.c_float, ctypes.c_float,
                              ctypes.c_float, p, p, p, p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, p])
        return self._fn

    @staticmethod
    def _x_layout_ok(x: Tensor) -> bool:
        return x.is_contiguous()

    def _check(self, z: Tensor, data: FusedFamily):
        if data.family != self.family:
            raise ValueError(f"{self.name} computes {self.family}, got {data.family}")
        if data.x.dtype != self.x_dtype:
            raise TypeError(f"{self.name} takes x as {self.x_dtype}, got {data.x.dtype}")
        if z.dtype != torch.float32 or z.dim() != 2 or not z.is_contiguous():
            raise TypeError(f"{self.name} takes z as a contiguous [C, D] float32 tensor")
        c, d = z.shape
        n = data.x.shape[0]
        want = {"x": (n, d), "y": (n,), "b": (n,), "prior_mean": (d,), "prior_inv_var": (d,)}
        if self.family == "normal_learned":
            want["u"] = (d,)
        for field, shape in want.items():
            t = getattr(data, field)
            layout_ok = self._x_layout_ok(t) if field == "x" else t.is_contiguous()
            if tuple(t.shape) != shape or t.device != z.device or not layout_ok:
                raise ValueError(
                    f"{self.name}: {field} must be a {shape} tensor on {z.device} "
                    f"laid out as build_glm_data makes it, got {tuple(t.shape)} on {t.device}")
            if field != "x" and t.dtype != torch.float32:
                raise TypeError(f"{self.name}: {field} must be float32")
        if c == 0 or n == 0 or d == 0:
            raise ValueError(f"{self.name}: empty input (C={c}, N={n}, D={d})")

    def __call__(self, z: Tensor, data: FusedFamily) -> Tuple[Tensor, Tensor]:
        if z.device.type == "cpu":
            return data.plain(z)
        if z.device.type != "cuda":
            raise RuntimeError(f"{self.name} runs on CUDA tensors, got {z.device}")
        self._check(z, data)
        fn = self._c_function()
        c, d = z.shape
        n = data.x.shape[0]
        val, grad, ll_part, g_part, splits, tiles_per_split = _two_pass_buffers(
            z, n, self._tiles)
        u_ptr = data.u.data_ptr() if data.u is not None else None
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            err = fn(z.data_ptr(), data.x.data_ptr(), data.y.data_ptr(), data.b.data_ptr(),
                     data.prior_mean.data_ptr(), data.prior_inv_var.data_ptr(), u_ptr,
                     float(data.c0), float(data.ll_scale), float(n),
                     val.data_ptr(), grad.data_ptr(), ll_part.data_ptr(), g_part.data_ptr(),
                     c, n, d, splits, tiles_per_split, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        return val, grad


def glm_vg_function(symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/glm_vg.cu`` (built and loaded at
    first use) with its argument types set, and the library's tile sizes
    (chains, rows) per block."""
    from .cuda_build import load_library

    lib = load_library("glm_vg")
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    for tile in (lib.glm_vg_block_chains, lib.glm_vg_block_rows):
        tile.argtypes = []
        tile.restype = ctypes.c_int
    return fn, (lib.glm_vg_block_chains(), lib.glm_vg_block_rows())


def _two_pass_buffers(z: Tensor, n: int, tiles: Tuple[int, int]):
    """Outputs and scratch of one two-pass launch over z [C,D] and N rows:
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


class BernoulliTiles(NamedTuple):
    """Tiles of K1/K2 (``csrc/glm_bernoulli_sm90.cuh``), in the order
    ``glm_bern_tiles`` reports them."""

    chains_a: int  # pass A: chains per block
    rows_a: int  # pass A: X rows per tile (one log-lik partial each)
    chains_b: int  # pass B: chains per block
    cols_b: int  # pass B: D columns per block
    rows_b: int  # pass B: rows per depth step (a split is a multiple)
    align: int  # elements in 16 bytes: every row stride is a multiple
    blocks_per_sm: int  # blocks one multiprocessor holds (registers, shared memory)


BERNOULLI_TILES = {
    "f32": BernoulliTiles(128, 128, 128, 128, 16, 4, 2),
    "bf16": BernoulliTiles(64, 128, 64, 128, 64, 8, 3),
}


class BernoulliPlan(NamedTuple):
    """How one K1/K2 call is cut: the scratch strides (elements), the row
    tiles of pass A and the row splits of pass B."""

    ldz: int  # z scratch [C, ldz], operand type
    ldr: int  # residual scratch [C, ldr], operand type
    ldg: int  # gradient partials [splits, C, ldg], f32
    row_tiles: int  # log-lik partials [C, row_tiles], f32
    splits: int
    rows_per_split: int

    def scratch_shapes(self, c: int) -> Dict[str, Tuple[int, ...]]:
        return {"z": (c, self.ldz), "resid": (c, self.ldr),
                "ll_part": (c, self.row_tiles), "g_part": (self.splits, c, self.ldg)}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def plan_bernoulli(c: int, n: int, d: int, dtype: str, sms: int) -> BernoulliPlan:
    """The passes of one K1 (dtype 'f32') or K2 ('bf16') call over z [C,D]
    and N rows on a card with ``sms`` multiprocessors.  Every scratch row
    stride is a multiple of 16 bytes (TMA and 16-byte copies need it; f32
    partials a multiple of 4 elements).  Pass A has one tile per
    ``rows_a`` rows.  Pass B cuts the rows into splits of whole depth steps:
    as many as let every (chain block, column block, split) run in one wave
    of ``blocks_per_sm`` blocks per multiprocessor (a second, nearly empty
    wave would double the pass), and none empty."""
    t = BERNOULLI_TILES[dtype]
    steps = -(-n // t.rows_b)
    blocks = -(-c // t.chains_b) * -(-d // t.cols_b)
    splits = max(1, min(steps, t.blocks_per_sm * sms // blocks))
    steps_per_split = -(-steps // splits)
    splits = -(-steps // steps_per_split)
    return BernoulliPlan(ldz=_round_up(d, t.align), ldr=_round_up(n, t.align),
                         ldg=_round_up(d, 4), row_tiles=-(-n // t.rows_a), splits=splits,
                         rows_per_split=steps_per_split * t.rows_b)


def x_row_aligned(x: Tensor) -> bool:
    """X [N, D] as K1/K2 read it: unit column stride, rows 16-byte aligned."""
    row_bytes = x.stride(0) * x.element_size()
    return (x.dim() == 2 and x.stride(1) == 1 and x.stride(0) >= x.shape[1]
            and row_bytes % 16 == 0 and x.data_ptr() % 16 == 0)


def align_rows(x: Tensor) -> Tensor:
    """X [N, D] with its rows 16 bytes aligned: X itself when they are, else
    a view of the first D columns of a zero-padded [N, D'] buffer."""
    if x.is_contiguous() and x_row_aligned(x):
        return x
    n, d = x.shape
    buf = torch.zeros((n, _round_up(d, 16 // x.element_size())), dtype=x.dtype, device=x.device)
    buf[:, :d] = x
    return buf[:, :d]


class BernoulliScratch:
    """K1/K2's workspace for one FusedFamily (``build_glm_data`` makes it
    with the data, so it is freed with the data): the plan and the scratch
    tensors of the last (device, stream, C, X) it served, and K2's four TMA
    tensor maps of that X and scratch.  The next call with the same key
    runs after the last in stream order and reuses them; a call with
    another key replaces them."""

    __slots__ = ("key", "plan", "tensors", "maps")

    def __init__(self):
        self.key = self.plan = self.tensors = self.maps = None


class BernoulliKernel(GlmKernel):
    """Wrapper of K1/K2 (``csrc/glm_bernoulli_sm90.cuh``, entries in
    ``glm_vg.cu``).  One call launches the passes ``plan_bernoulli`` lays
    out and counts one launch.

    The scratch of a call (z staged, the residual, the partials) and K2's
    tensor maps live in the data's ``BernoulliScratch``, so the host's
    work per call is two output allocations and the launches, which is
    what a launch-bound call at the floor shape pays.  Data without one
    (a FusedFamily built by hand) gets fresh scratch on every call."""

    source = "brancher_torch/csrc/glm_bernoulli_sm90.cuh"

    def __init__(self, name: str, x_dtype: torch.dtype, symbol: str, replaces: str):
        super().__init__(name, "bernoulli_logit", x_dtype, symbol, replaces)
        self.dtype = "bf16" if x_dtype == torch.bfloat16 else "f32"
        self._encode = None

    _x_layout_ok = staticmethod(x_row_aligned)

    def _c_function(self):
        if self._fn is None:
            from .cuda_build import load_library

            lib = load_library("glm_vg")
            lib.glm_bern_tiles.argtypes = [ctypes.c_int, ctypes.c_void_p]
            lib.glm_bern_tiles.restype = ctypes.c_int
            got = (ctypes.c_int * len(BernoulliTiles._fields))()
            lib.glm_bern_tiles(int(self.dtype == "bf16"), ctypes.addressof(got))
            if tuple(got) != tuple(BERNOULLI_TILES[self.dtype]):
                raise RuntimeError(f"{self.name}: the library's tiles {tuple(got)} are not "
                                   f"the planner's {tuple(BERNOULLI_TILES[self.dtype])}")
            p, i = ctypes.c_void_p, ctypes.c_int
            fn = getattr(lib, self.symbol)
            fn.argtypes = [p] * 7 + [ctypes.c_float] + [p] * 6 + [i] * 10 + [p]
            fn.restype = ctypes.c_int
            lib.glm_bern_encode_maps.argtypes = [p, i, p, i, p, i, i, i, i, p]
            lib.glm_bern_encode_maps.restype = ctypes.c_int
            self._fn, self._encode = fn, lib.glm_bern_encode_maps
        return self._fn

    def _fill(self, scratch: BernoulliScratch, key: tuple, x: Tensor, c: int):
        """Plan, allocate and (K2) encode ``scratch`` for ``key``.  A tensor
        map holds the pointer, shape and strides it was encoded for, so the
        key holds X's pointer and stride, and the scratch is new with it."""
        device, n, d = x.device, x.shape[0], x.shape[1]
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = plan_bernoulli(c, n, d, self.dtype, sms)
        shapes = plan.scratch_shapes(c)
        zs = torch.empty(shapes["z"], device=device, dtype=self.x_dtype)
        resid = torch.empty(shapes["resid"], device=device, dtype=self.x_dtype)
        tensors = (zs, resid, torch.empty(shapes["ll_part"], device=device, dtype=torch.float32),
                   torch.empty(shapes["g_part"], device=device, dtype=torch.float32))
        maps = None
        if self.dtype == "bf16":
            maps = ctypes.create_string_buffer(4 * 128)
            err = self._encode(x.data_ptr(), x.stride(0), zs.data_ptr(), plan.ldz,
                               resid.data_ptr(), plan.ldr, c, n, d, ctypes.addressof(maps))
            if err != 0:
                raise RuntimeError(f"{self.name}: encoding the tensor maps failed: CUDA error {err}")
        scratch.key, scratch.plan, scratch.tensors, scratch.maps = key, plan, tensors, maps

    def __call__(self, z: Tensor, data: FusedFamily) -> Tuple[Tensor, Tensor]:
        if z.device.type == "cpu":
            return data.plain(z)
        return self._launch(z, data)[:2]

    def residual(self, z: Tensor, data: FusedFamily) -> Tensor:
        """The residual [C, N] of one launch, in the operand type (for K2
        with its bf16 rounding): what the second product read."""
        return self._launch(z, data)[2].clone()

    def _launch(self, z: Tensor, data: FusedFamily) -> Tuple[Tensor, Tensor, Tensor]:
        if z.device.type != "cuda":
            raise RuntimeError(f"{self.name} runs on CUDA tensors, got {z.device}")
        self._check(z, data)
        fn = self._c_function()
        c, d = z.shape
        x = data.x
        n = x.shape[0]
        f32 = dict(device=z.device, dtype=torch.float32)
        val, grad = torch.empty((c,), **f32), torch.empty((c, d), **f32)
        scratch = data.scratch if data.scratch is not None else BernoulliScratch()
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            key = (z.device, stream, c, x.data_ptr(), x.stride(0), n, d)
            if scratch.key != key:
                self._fill(scratch, key, x, c)
            plan, (zs, resid, ll_part, g_part) = scratch.plan, scratch.tensors
            maps = None if scratch.maps is None else ctypes.addressof(scratch.maps)
            err = fn(z.data_ptr(), x.data_ptr(), maps, data.y.data_ptr(), data.b.data_ptr(),
                     data.prior_mean.data_ptr(), data.prior_inv_var.data_ptr(),
                     float(data.ll_scale), val.data_ptr(), grad.data_ptr(), zs.data_ptr(),
                     resid.data_ptr(), ll_part.data_ptr(), g_part.data_ptr(), c, n, d,
                     x.stride(0), plan.ldz, plan.ldr, plan.ldg, plan.row_tiles, plan.splits,
                     plan.rows_per_split, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        return val, grad, resid[:, :n]


_SRC = "brancher_tpu/ops/pallas_glm.py"
KERNELS: Dict[str, GlmKernel] = {
    k.name: k for k in (
        BernoulliKernel("glm_bernoulli_f32", torch.float32,
                        "glm_vg_bernoulli_f32", f"{_SRC}:179 _bern_kernel"),
        BernoulliKernel("glm_bernoulli_bf16", torch.bfloat16,
                        "glm_vg_bernoulli_bf16", f"{_SRC}:240 _bern_kernel_bf16"),
        GlmKernel("glm_normal_f32", "normal_learned", torch.float32,
                  "glm_vg_normal_f32", f"{_SRC}:207 _normal_kernel"),
        GlmKernel("glm_normal_bf16", "normal_learned", torch.bfloat16,
                  "glm_vg_normal_bf16", f"{_SRC}:278 _normal_kernel_bf16"),
    )
}


def kernel_for(family: str, dtype: str) -> GlmKernel:
    stem = {"bernoulli_logit": "bernoulli", "normal_learned": "normal"}[family]
    return KERNELS[f"glm_{stem}_{dtype}"]


def build_glm_data(family, x, y, b, prior_mean, prior_inv_var, u=None, c0=0.0,
                   ll_scale=1.0, dtype="f32", device=None, align_x=True) -> FusedFamily:
    """Prepare the data of a fused potential once: move it to ``device``
    (default ``config.device``), make it contiguous, and for dtype='bf16'
    cast the design matrix to bf16.  For bernoulli_logit (K1/K2) X's rows
    start 16 bytes apart (``align_rows``: a padded buffer when D is not a
    multiple of 16 bytes) unless ``align_x`` is False, for a reader that
    takes X contiguous (K5), and the data carries K1/K2's scratch."""
    if family not in ("bernoulli_logit", "normal_learned"):
        raise ValueError(f"unknown GLM family {family!r}")
    if dtype not in ("f32", "bf16"):
        raise ValueError(f"dtype must be 'f32' or 'bf16', got {dtype!r}")
    dev = resolve_device(device)

    def vec(t):
        return torch.as_tensor(t, dtype=torch.float32).to(dev).reshape(-1).contiguous()

    xd = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
    if dtype == "bf16":
        xd = xd.to(torch.bfloat16)
    bernoulli = family == "bernoulli_logit"
    if bernoulli and align_x:
        xd = align_rows(xd)
    return FusedFamily(
        family, xd, vec(y), vec(b), None if u is None else vec(u), float(c0),
        vec(prior_mean), vec(prior_inv_var), float(ll_scale),
        BernoulliScratch() if bernoulli else None,
    )


def build_glm_vg(family, x, y, b, prior_mean, prior_inv_var, u=None, c0=0.0,
                 ll_scale=1.0, dtype="f32", device=None) -> Callable[[Tensor], Tuple[Tensor, Tensor]]:
    """fn(z [C,D]) -> (val [C], grad [C,D]) over data prepared once.
    On a CUDA device every call launches the hand-written kernel."""
    data = build_glm_data(family, x, y, b, prior_mean, prior_inv_var, u=u, c0=c0,
                          ll_scale=ll_scale, dtype=dtype, device=device)
    kernel = kernel_for(family, dtype)
    return lambda z: kernel(z, data)


# ======================================================================
# Numeric recognizer
# ======================================================================

class _NotAGlm(Exception):
    """Raised inside a probe when the model's structure is not a GLM's."""


def _per_row(t: Tensor, n: int) -> Tensor:
    """``t`` broadcast over the ``n`` observed rows; a parameter of another
    shape is not a GLM's (checked here, as broadcast_to would raise a
    RuntimeError)."""
    if t.numel() not in (1, n):
        raise _NotAGlm(f"parameter of shape {tuple(t.shape)} over {n} rows")
    return torch.broadcast_to(t.reshape(-1), (n,))


def _affine_probe(f: Callable[[Tensor], Tensor], dim: int, device,
                  rtol: float = 3e-3) -> Optional[Tuple[Tensor, Tensor]]:
    """Extract (X, b) with f(z) = X@z + b, verified at a random point.
    Probes are vmapped: one batched graph evaluation."""
    rng = np.random.RandomState(0)
    zr = rng.normal(0, 1, size=(1, dim)).astype(np.float32)
    probes = np.concatenate([np.zeros((1, dim), np.float32), np.eye(dim, dtype=np.float32), zr])
    with torch.no_grad():
        outs = torch.func.vmap(f)(torch.as_tensor(probes, device=device))
    b = outs[0]
    x = (outs[1:1 + dim] - b[None, :]).T.contiguous()  # [M, D]
    zr_t = torch.as_tensor(zr[0], device=device)
    pred = x @ zr_t + b
    scale = max(float(torch.max(torch.abs(outs[-1]))), 1.0)
    if not bool(torch.all(torch.abs(pred - outs[-1]) <= rtol * scale + 1e-5 * torch.abs(outs[-1]))):
        return None
    return x, b


def _diag_gaussian_prior(prior_f, dim: int, device, rtol: float = 3e-3):
    """Verify lp(z) is a diagonal quadratic; return (mean, inv_var)."""
    eye = np.eye(dim, dtype=np.float32)
    rng = np.random.RandomState(1)
    zr = rng.normal(0, 1.5, size=(2, dim)).astype(np.float32)
    probes = np.concatenate([np.zeros((1, dim), np.float32), eye, -eye, zr])
    with torch.no_grad():
        outs = torch.func.vmap(prior_f)(torch.as_tensor(probes, device=device)).cpu().numpy()
    lp0 = outs[0]
    lp_p = outs[1:1 + dim]
    lp_m = outs[1 + dim:1 + 2 * dim]
    inv_var = -(lp_p + lp_m - 2.0 * lp0)  # curvature per coordinate
    if np.any(inv_var <= 0) or not np.all(np.isfinite(inv_var)):
        return None
    # lp(e_i) - lp(0) = -(1 - 2 m_i) inv_var_i / 2
    mean = (2.0 * (lp_p - lp0) / inv_var + 1.0) / 2.0
    for i, z in enumerate(zr):
        pred = lp0 - 0.5 * float(np.sum((z - mean) ** 2 * inv_var)) + 0.5 * float(
            np.sum(mean**2 * inv_var))
        if not np.isclose(pred, outs[1 + 2 * dim + i], atol=rtol * max(abs(pred), 1.0)):
            return None
    return mean.astype(np.float32), inv_var.astype(np.float32)


def _scale_is_shared(obs_params_f, key_name: str, dim: int, device) -> bool:
    """True iff the observed scale is one shared value across elements at
    a random probe point (normal_learned has one log-noise per chain)."""
    zr = torch.as_tensor(np.random.RandomState(5).normal(0, 1, dim).astype(np.float32), device=device)
    with torch.no_grad():
        sc = torch.atleast_1d(obs_params_f(zr)[key_name]).reshape(-1)
    return bool(torch.all(torch.abs(sc - sc[0]) <= 1e-6 * torch.abs(sc[0])))


def _extract_normal_learned(f_loc, f_logscale, y, dim, device, prior_mean,
                            prior_inv_var, ll_scale) -> Optional[FusedFamily]:
    """loc = X z + b and log-scale = u.z + c0, both probed as affine maps."""
    ab = _affine_probe(f_loc, dim, device)
    if ab is None:
        return None
    ab_s = _affine_probe(f_logscale, dim, device)
    if ab_s is None:
        return None
    return FusedFamily("normal_learned", ab[0], y, ab[1].contiguous(),
                       ab_s[0][0].contiguous(), float(ab_s[1][0]),
                       prior_mean, prior_inv_var, ll_scale)


def recognize_fused_family(comp, params, given=None) -> Optional[FusedFamily]:
    """Numerically extract the GLM structure of ``comp``'s potential.

    Returns a FusedFamily that matches ``comp.log_density_z`` up to an
    additive constant (values and gradients, at three random points), or
    None when the model is not a recognized GLM.  Only the errors that say
    "not a GLM" are read as such: a missing parameter, a shape that does
    not broadcast over the rows, a distribution the walk does not support.
    The probes run on the model's device, so a RuntimeError (out of
    memory, a CUDA fault, a vmap failure the autodiff path would hit too)
    reaches the caller instead of quietly leaving the kernel path.
    """
    given = given or {}
    try:
        return _recognize(comp, params, given)
    except (_NotAGlm, ValueError, KeyError, IndexError, NotImplementedError):
        return None


def _recognize(comp, params, given) -> Optional[FusedFamily]:
    from ..variables import PartialLink

    if comp.discrete_latent_names and not all(n in given for n in comp.discrete_latent_names):
        return None
    if len(comp.observed_names) != 1:
        return None
    obs_name = comp.observed_names[0]
    obs_var = next(v for v in comp.order if v.name == obs_name)
    if isinstance(obs_var._observed, PartialLink):
        return None  # data-loader observation: data is not constant
    dev = comp.device
    dim = comp.dim
    if dim == 0 or dim > 4096:
        return None

    def prior_f(zf):
        return comp.log_prior_z(params, comp.unravel_z(zf), given)

    pr = _diag_gaussian_prior(prior_f, dim, dev)
    if pr is None:
        return None
    prior_mean = torch.as_tensor(pr[0], device=dev)
    prior_inv_var = torch.as_tensor(pr[1], device=dev)

    def obs_params_f(zf):
        return comp.eval_observed_params(params, comp.unravel_z(zf), given)[obs_name]

    dist = obs_var.distribution
    ll_scale = float(obs_var.log_prob_scale)
    y_val = obs_var._observed.to(device=dev, dtype=torch.float32).reshape(-1)
    n = y_val.shape[0]

    if isinstance(dist, Bernoulli):
        if "logits" not in obs_var.links:
            return None

        def f_logits(zf):
            return _per_row(obs_params_f(zf)["logits"], n)

        ab = _affine_probe(f_logits, dim, dev)
        if ab is None:
            return None
        fam = FusedFamily("bernoulli_logit", ab[0], y_val, ab[1].contiguous(), None, 0.0,
                          prior_mean, prior_inv_var, ll_scale)
    elif isinstance(dist, Normal):
        if not _scale_is_shared(obs_params_f, "scale", dim, dev):
            return None

        def f_loc(zf):
            return _per_row(obs_params_f(zf)["loc"], n)

        def f_logscale(zf):
            return torch.log(torch.atleast_1d(obs_params_f(zf)["scale"]).reshape(-1)[0:1])

        fam = _extract_normal_learned(f_loc, f_logscale, y_val, dim, dev,
                                      prior_mean, prior_inv_var, ll_scale)
    else:
        return None  # Categorical / AutoRegressive: ROADMAP queue 1, items 13-14
    if fam is None:
        return None

    # ---- final self-check vs the autodiff density ----------------------
    def pot(zf):
        return comp.log_density_z(params, comp.unravel_z(zf), given)

    rng = np.random.RandomState(2)
    zs = torch.as_tensor(rng.normal(0, 1, size=(3, dim)).astype(np.float32), device=dev)
    g_ref, v_ref = torch.func.vmap(torch.func.grad_and_value(pot))(zs)
    with torch.no_grad():
        v_f, g_f = fam.plain(zs)
    dv = v_f - v_ref
    scale_v = max(1.0, float(torch.max(torch.abs(v_ref))))
    scale_g = max(1.0, float(torch.max(torch.abs(g_ref))))
    if float(torch.max(torch.abs(dv - dv[0]))) > 3e-3 * scale_v:
        return None
    if float(torch.max(torch.abs(g_f - g_ref))) > 3e-3 * scale_g:
        return None
    return fam


def glm_flops(c: int, n: int, d: int) -> int:
    """Operations of one value+grad call: two products through X."""
    return 4 * c * n * d


def glm_bytes(c: int, n: int, d: int, x_bytes: int, family: str) -> int:
    """Least bytes one call moves: each input read once (z, X, y, b, the
    prior and, for normal_learned, u), each output written once (val,
    grad)."""
    d_vectors = 3 if family == "normal_learned" else 2
    return n * d * x_bytes + 2 * n * 4 + (2 * c * d + c) * 4 + d_vectors * d * 4


__all__ = [
    "bernoulli_vg_reference", "bernoulli_vg_reference_bf16",
    "bernoulli_residual_reference", "bernoulli_grad_given_residual", "bf16_rounding_flips",
    "bf16_residual_readings",
    "normal_vg_reference", "normal_vg_reference_bf16",
    "GlmKernel", "BernoulliKernel", "BernoulliScratch", "KERNELS", "kernel_for", "build_glm_data",
    "BernoulliTiles", "BERNOULLI_TILES", "BernoulliPlan", "plan_bernoulli",
    "align_rows", "x_row_aligned",
    "build_glm_vg", "FusedFamily", "recognize_fused_family",
    "glm_flops", "glm_bytes",
]
