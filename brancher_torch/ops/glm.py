"""Fused GLM value+grad: plain versions, CUDA kernel wrappers, recognizer.

Counterpart of ``brancher_tpu/ops/pallas_glm.py``.  Two families cover
the dense likelihoods of the model zoo:

  * ``bernoulli_logit``  y_n ~ Bernoulli(sigmoid(x_n.z + b_n))
  * ``normal_learned``   y_n ~ N(x_n.z + b_n, exp(u.z + c0))

For each family and design-matrix type (f32, bf16) there is a plain
PyTorch version (``*_vg_reference*``) and a kernel written by hand in CUDA:
K1 (Bernoulli, f32), K2 (Bernoulli, bf16), K3 (Normal, f32), K4 (Normal,
bf16).  All four run the passes of ``csrc/glm_sm90.cuh``, planned by
``plan_glm``: the bf16 kernels on the tensor cores through ``wgmma`` fed
by TMA, the f32 ones register-tiled on the CUDA cores fed by ``cp.async``;
at narrow width (``takes_narrow_pass``) the f32 ones run one fused pass
instead of two, with no residual scratch.
The families differ only in the elementwise middle and the epilogue.  The
wrapper (``GlmKernel``) takes a tensor on the CPU to the plain version and
a tensor on a CUDA device to the kernel; there is no fallback from the
kernel to the plain version.

``recognize_fused_family`` numerically probes a compiled model: it checks
that the z-space prior is a diagonal Gaussian, extracts the affine design
of the observed likelihood's parameters, and self-checks the assembled
potential against the autodiff log-density before trusting it.  It
probes on the model's device.  An observed AR(p) series is the
normal_learned family over its lag matrix.  An observed Categorical with
affine logits is the softmax family (``CategoricalFusedFamily``: each
latent coordinate scattered into one (feature, class) cell of a weight
matrix, ``categorical_vg_reference``).  The JAX package has no Pallas
kernel for it, only two einsums, so neither has the port: its value+grad
is plain PyTorch (``torch.einsum`` and ``scatter_add``) on every device,
and it is not ``auto_upgradable``: ``sample()`` keeps a softmax model on
autodiff, as JAX does.  A series observed with a ``log_prob_mask``
(missing data) fails the self-check, as in the JAX package, since the
family counts every row.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..distributions import Bernoulli, Categorical, Normal, softplus
from ..stochastic_processes import AutoRegressive

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


def categorical_vg_reference(z, x, y_onehot, c, cols, ks, prior_mean, prior_inv_var,
                             ll_scale=1.0):
    """Structure-preserving softmax potential: z [C,D] -> (val [C], grad
    [C,D]) (JAX ``pallas_glm.py:145-172``).

    Each flat latent coordinate j is one (feature, class) cell (cols[j],
    ks[j]) of an effective weight matrix W [m, K], with design x [N, m]
    and logit offsets c [N, K]: logits = x @ W(z) + c.  Batched 3-D
    products, O(C N K m) operations instead of O(C N K D)."""
    ch, d = z.shape
    m, k = x.shape[1], y_onehot.shape[1]
    cell = (cols * k + ks).to(torch.int64)  # [D] flat (feature, class) index
    w = torch.zeros((ch, m * k), dtype=z.dtype, device=z.device).scatter_add(
        1, cell.expand(ch, d), z).reshape(ch, m, k)
    logits = torch.einsum("nm,cmk->cnk", x, w) + c[None]  # [C, N, K]
    ll = torch.sum(torch.sum(y_onehot[None] * logits, -1) - torch.logsumexp(logits, -1), dim=-1)
    dz = z - prior_mean[None, :]
    val = ll_scale * ll - 0.5 * torch.sum(dz * dz * prior_inv_var[None, :], dim=-1)
    resid = y_onehot[None] - torch.softmax(logits, dim=-1)  # [C, N, K]
    gw = torch.einsum("nm,cnk->cmk", x, resid).reshape(ch, m * k)
    grad = ll_scale * gw[:, cell] - dz * prior_inv_var[None, :]
    return val, grad


def residual_reference(z, data):
    """The plain version's f32 residual [C, N] before any bf16 rounding:
    y - sigmoid(l) for bernoulli_logit, y - loc for normal_learned (bf16
    multiplies when X is bf16)."""
    x = data.x
    lin = (_bf16_matmul(z, x.T) if x.dtype == torch.bfloat16 else z @ x.T) + data.b[None, :]
    if data.family == "bernoulli_logit":
        return data.y[None, :] - torch.sigmoid(lin)
    return data.y[None, :] - lin


def residual_weight(z, data):
    """The factor [C] by which each chain's residual product enters the
    likelihood's gradient: e2 = exp(-2 (z.u + c0)) for normal_learned, 1
    for bernoulli_logit."""
    if data.family == "bernoulli_logit":
        return torch.ones(z.shape[0], dtype=torch.float32, device=z.device)
    return torch.exp(-2.0 * (z @ data.u + data.c0))


def grad_given_residual(resid, z, data):
    """The plain version's gradient with the residual [C, N] given, its
    rounding included, in f32.  For normal_learned the rss term comes from
    the plain version's f32 residual, as each kernel takes it from its own
    f32 residual and rounds only the product's operand."""
    dz = z - data.prior_mean[None, :]
    g_x = resid.float() @ data.x.float()
    if data.family == "normal_learned":
        r32 = residual_reference(z, data)
        e2 = residual_weight(z, data)
        g_s = e2 * torch.sum(r32 * r32, -1) - data.y.shape[0]
        g_x = e2[:, None] * g_x + g_s[:, None] * data.u[None, :]
    return data.ll_scale * g_x - dz * data.prior_inv_var[None, :]


# A bf16 kernel's residual that is not the bf16 rounding of the plain f32
# residual is a tie when the plain residual lay within TIE_UNITS units of
# its f32 precision (``residual_unit``) of rounding to the kernel's value:
# the two linear predictors, summed in two orders, differ in their last
# bits.  On an H100 the farthest of K2's ties lay 64 units away, of the
# 32,768 a residual can lie from a rounding boundary (PERF.md).
TIE_UNITS = 1024


def residual_unit(r32, z, data):
    """The f32 precision of each plain residual [C, N]: one unit in the
    last place of |y - sigmoid(l)| for bernoulli_logit.  For
    normal_learned, y - loc carries loc's rounding, which any summation
    order bounds by the last place of the sum of loc's absolute terms
    (|b| + |z| |x|, z rounded as the product takes it): one unit in the
    last place of the larger of that sum and |y|."""
    mag = r32.abs()
    if data.family == "normal_learned":
        x = data.x.float()
        zz = z.to(torch.bfloat16).float() if data.x.dtype == torch.bfloat16 else z
        terms = zz.abs() @ x.abs().T + data.b.abs()[None, :]
        mag = torch.maximum(data.y.abs()[None, :], terms)
    return torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag


def _bf16_interval(v16):
    """(lo, hi) in f64: the f32 values whose bf16 rounding is ``v16``, the
    midpoints to its two bf16 neighbours (ties to even aside)."""
    bits = v16.float().contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    away = (mag + 0x8000).view(torch.float32).double()
    half = torch.tensor(0x8000, dtype=torch.int32).view(torch.float32).double()
    toward = torch.where(mag == 0, -half.to(v16.device),
                         (mag - 0x8000).clamp(min=0).view(torch.float32).double())
    neg = bits < 0
    return torch.where(neg, -away, toward), torch.where(neg, -toward, away)


def bf16_rounding_flips(resid16, resid32, unit):
    """Where a bf16 residual is not the round-to-nearest-even of the f32
    one: (flips, units).  ``units`` is each f32 value's distance from the
    f32 values that round to ``resid16``, in ``unit``s (0 where it rounds
    there): for the other bf16 neighbour, the distance from the midpoint
    between the two; infinite where ``resid16`` is no bf16 value (a
    residual that was not rounded)."""
    r, v = resid32.double(), resid16.float()
    lo, hi = _bf16_interval(resid16)
    units = ((lo - r).clamp(min=0) + (r - hi).clamp(min=0)) / unit.double()
    units = torch.where(v == v.to(torch.bfloat16).float(), units, float("inf"))
    return v != resid32.float().to(torch.bfloat16).float(), units


def _rel(got: Tensor, ref: Tensor) -> float:
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def bf16_residual_readings(g, resid, z, data, g_ref) -> Dict[str, float]:
    """What the checks of a bf16 kernel (K2, K4) read for a gradient ``g``
    that was computed from the residual ``resid`` [C, N], against the
    plain version's gradient ``g_ref`` on the bf16 ``data``.

    ``resid_flips`` counts the residuals that are not the bf16 rounding of
    the plain version's f32 residual, and ``flip_tie_units_max`` says how
    far the farthest of those that are bf16 values lay from rounding to the
    kernel's value, in units of the residual's f32 precision
    (``bf16_rounding_flips``, ``residual_unit``).  A flip within
    ``TIE_UNITS`` is a tie: the two linear predictors, summed in two
    orders, differ in their last bits, and the residual lay that close to
    a bf16 rounding boundary.  ``flips_legal`` says whether every flip is
    a tie.  A tie moves its
    chain's gradient by its bf16 step times ll_scale times the chain's
    ``residual_weight`` (e2 for normal_learned) times its row of X, so
    ``flip_allowance_rel`` is ll_scale times the largest sum over one
    chain's ties of that step times the weight times the row's max|X|,
    over max(max|g_ref|, 1): 0 where no residual differs.
    ``grad_max_rel`` is the raw error against ``g_ref`` and
    ``grad_given_resid_rel`` the error against the plain formula on
    ``resid`` (``grad_given_residual``), both in that scale."""
    r32 = residual_reference(z, data)
    flips, units = bf16_rounding_flips(resid, r32, residual_unit(r32, z, data))
    ties = flips & (units <= TIE_UNITS)
    n_flips = int(flips.sum())
    step = torch.where(ties, (resid.float() - r32.to(torch.bfloat16).float()).abs(), 0.0)
    move = residual_weight(z, data) * (step @ data.x.float().abs().amax(1))
    scale = max(float(g_ref.abs().max()), 1.0)
    far = units[flips & units.isfinite()]
    return {
        "resid_flips": n_flips, "flip_share": n_flips / resid.numel(),
        "flips_legal": bool(torch.equal(flips, ties)),
        "flip_tie_units_max": float(far.max()) if far.numel() else 0.0,
        "grad_max_rel": _rel(g, g_ref),
        "flip_allowance_rel": abs(data.ll_scale) * float(move.max()) / scale,
        "grad_given_resid_rel": _rel(g, grad_given_residual(resid, z, data)),
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
    scratch: Optional["GlmScratch"] = None  # K1-K4's, as long as the data lives

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


class CategoricalFusedFamily(NamedTuple):
    """The softmax GLM: logits = x @ W(z) + c, each latent coordinate
    scattered into one (feature, class) cell (JAX ``pallas_glm.py:679-716``).

    Not auto-upgraded (``auto_upgradable``): in the JAX package, autodiff
    of the DSL's own ``matmul(x, w)`` already gives the structure-preserving
    batched products and measured faster on its chip; the family stays
    available, verified against autodiff by the recognizer, for graphs that
    hide the product.  It has no kernel: its value+grad is the plain
    version on every device."""

    auto_upgradable = False  # class attribute, not a field
    family = "categorical"

    x: Tensor  # [N, m] effective design
    y_onehot: Tensor  # [N, K]
    c: Tensor  # [N, K] logit offsets
    cols: Tensor  # [D] feature index of each latent coordinate
    ks: Tensor  # [D] class index of each latent coordinate
    prior_mean: Tensor
    prior_inv_var: Tensor
    ll_scale: float

    def value_and_grad(self, dtype: str = "f32") -> Callable[[Tensor], Tuple[Tensor, Tensor]]:
        if dtype != "f32":
            raise ValueError("dtype='bf16' supports the bernoulli_logit and normal_learned "
                             "families, not 'categorical'")
        return self.plain

    def leapfrog(self):
        from .leapfrog import reference_leapfrog

        return reference_leapfrog(self.value_and_grad())

    def plain(self, z: Tensor) -> Tuple[Tensor, Tensor]:
        return categorical_vg_reference(z, self.x, self.y_onehot, self.c, self.cols, self.ks,
                                        self.prior_mean, self.prior_inv_var, self.ll_scale)


def _extract_categorical(a_mat: np.ndarray, b_vec: np.ndarray, y_int: np.ndarray, n: int,
                         num_classes: int, dim: int, prior_mean, prior_inv_var, ll_scale,
                         device) -> Optional[CategoricalFusedFamily]:
    """The Kronecker (feature x class) structure of the affine logit map A
    [N*K, D] as a CategoricalFusedFamily, or None (JAX ``pallas_glm.py:
    719-756``, the same numpy arithmetic on the host)."""
    a3 = a_mat.reshape(n, num_classes, dim)
    tol = 1e-5 * max(float(np.abs(a3).max()), 1.0)
    patterns: list = []
    cols = np.zeros(dim, np.int64)
    ks_arr = np.zeros(dim, np.int64)
    for j in range(dim):
        aj = a3[:, :, j]  # [N, K]
        nz = np.nonzero(np.abs(aj).max(axis=0) > tol)[0]
        if len(nz) == 0:
            v, k_j = np.zeros(n, np.float32), 0
        elif len(nz) == 1:
            k_j = int(nz[0])
            v = aj[:, k_j].astype(np.float32)
        else:
            return None  # the coordinate feeds several classes: not Kronecker
        for mi, pv in enumerate(patterns):
            if np.allclose(v, pv, atol=tol):
                col = mi
                break
        else:
            patterns.append(v)
            col = len(patterns) - 1
        cols[j], ks_arr[j] = col, k_j
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return CategoricalFusedFamily(
        as_t(np.stack(patterns, axis=1)), as_t(np.eye(num_classes, dtype=np.float32)[y_int]),
        as_t(b_vec.reshape(n, num_classes).astype(np.float32)), as_t(cols), as_t(ks_arr),
        prior_mean, prior_inv_var, ll_scale)


class GlmTiles(NamedTuple):
    """Tiles of K1-K4 (``csrc/glm_sm90.cuh``) for one operand type, in the
    order ``glm_sm90_tiles`` reports them."""

    chains_a: int  # pass A: chains per block
    rows_a: int  # pass A: X rows per tile (one log-lik or rss partial each)
    chains_b: int  # pass B: chains per block
    cols_b: int  # pass B: D columns per block
    rows_b: int  # pass B: rows per depth step (a split is a multiple)
    align: int  # elements in 16 bytes: every row stride is a multiple
    blocks_per_sm: int  # blocks one multiprocessor holds (registers, shared memory)


GLM_TILES = {
    "f32": GlmTiles(128, 128, 128, 128, 16, 4, 2),
    "bf16": GlmTiles(64, 128, 64, 128, 64, 8, 3),
}


class NarrowTiles(NamedTuple):
    """Tiles of the f32 narrow pass (``csrc/glm_sm90.cuh`` f32_narrow), in
    the order ``glm_sm90_narrow_tiles`` reports them."""

    rows: int  # X rows a tile; a split is whole tiles
    depth_align: int  # z and X are staged D rounded up to a multiple of this
    max_depth: int  # the widest D the pass takes
    threads: int  # threads a block
    blocks_per_sm: int  # blocks one multiprocessor holds (registers, shared memory)


NARROW_TILES = NarrowTiles(64, 8, 64, 256, 2)

# The f32 kernels (K1, K3, K6) run the narrow pass for D up to this width
# and passes A and B above it.  On an H100 (700 W), K1 at N = 581,012 took
# (narrow pass / passes A and B, ms) at C = 1024: D = 32 3.98 / 7.37, 55
# 4.72 / 8.22, 64 4.93 / 8.23; at C = 64: 0.297 / 0.948, 0.355 / 1.074,
# 0.367 / 1.068.  Past D' = 64 the pass's gradient tile leaves one block a
# multiprocessor, and a first build of it lost at C = 1024: D = 96 9.56 /
# 9.15, 128 10.56 / 10.10 (PERF.md).
NARROW_MAX_D = 64


class GlmPlan(NamedTuple):
    """How one K1-K4 call is cut: the scratch strides (elements), the row
    tiles of pass A and the row splits of pass B; or, where ``chain_tile``
    is not 0, the splits of the f32 narrow pass, which has no operand
    scratch (``ldz`` and ``ldr`` 0) and one log-lik or rss partial per
    split (``row_tiles`` = ``splits``)."""

    ldz: int  # z scratch [C, ldz], operand type
    ldr: int  # residual scratch [C, ldr], operand type
    ldg: int  # gradient partials [splits, C, ldg], f32
    row_tiles: int  # log-lik or rss partials [C, row_tiles], f32
    splits: int
    rows_per_split: int
    chain_tile: int = 0  # the narrow pass's chains a block (64 or 128); 0: passes A and B

    @property
    def narrow(self) -> bool:
        return self.chain_tile > 0

    def scratch_shapes(self, c: int) -> Dict[str, Tuple[int, ...]]:
        parts = {"ll_part": (c, self.row_tiles), "g_part": (self.splits, c, self.ldg)}
        if self.narrow:
            return parts
        return {"z": (c, self.ldz), "resid": (c, self.ldr), **parts}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


# The row stride that the planner gives the operand scratch and the data
# build gives X: 128 bytes, one row of a TMA box with the 128-byte swizzle.
# The kernels take any multiple of 16 bytes (what TMA and the 16-byte
# copies need), but at 16 bytes K4 at C=256, N=131072, D=1025 took 0.742
# ms against 0.445 at 128 (an H100, PERF.md): a box row then spans two
# 128-byte lines.
ROW_BYTES = 128


def takes_narrow_pass(d: int, dtype: str) -> bool:
    """Whether a call at width ``d`` runs the f32 narrow pass (K1, K3, K6
    at D <= ``NARROW_MAX_D``); the bf16 kernels never do."""
    return dtype == "f32" and d <= NARROW_MAX_D


def plan_glm(c: int, n: int, d: int, dtype: str, sms: int) -> GlmPlan:
    """The passes of one value+grad call over z [C,D] and N rows on a card
    with ``sms`` multiprocessors: the narrow pass where
    ``takes_narrow_pass``, else passes A and B (``plan_two_pass``)."""
    if takes_narrow_pass(d, dtype):
        return plan_narrow(c, n, d, sms)
    return plan_two_pass(c, n, d, dtype, sms)


def plan_two_pass(c: int, n: int, d: int, dtype: str, sms: int) -> GlmPlan:
    """Passes A and B for the f32 kernels (K1, K3; dtype 'f32') or the bf16
    ones (K2, K4; 'bf16'): both families share the passes.
    Every operand scratch row stride is a multiple of ``ROW_BYTES`` (TMA
    and 16-byte copies need 16; f32 partials a multiple of 4 elements).
    Pass A has one
    tile per ``rows_a`` rows.  Pass B cuts the rows into splits of whole
    depth steps: as many as let every (chain block, column block, split)
    run in one wave of ``blocks_per_sm`` blocks per multiprocessor (a
    second, nearly empty wave would double the pass), and none empty."""
    t = GLM_TILES[dtype]
    row = ROW_BYTES // (2 if dtype == "bf16" else 4)
    steps = -(-n // t.rows_b)
    blocks = -(-c // t.chains_b) * -(-d // t.cols_b)
    splits = max(1, min(steps, t.blocks_per_sm * sms // blocks))
    steps_per_split = -(-steps // splits)
    splits = -(-steps // steps_per_split)
    return GlmPlan(ldz=_round_up(d, row), ldr=_round_up(n, row),
                   ldg=_round_up(d, 4), row_tiles=-(-n // t.rows_a), splits=splits,
                   rows_per_split=steps_per_split * t.rows_b)


def plan_narrow(c: int, n: int, d: int, sms: int) -> GlmPlan:
    """The f32 narrow pass: a chain tile of 64 where C <= 64, else 128, and
    the rows cut into splits of whole tiles, as many as let every (chain
    tile, split) block run in one wave of ``blocks_per_sm`` blocks per
    multiprocessor, none empty."""
    t = NARROW_TILES
    if d > t.max_depth:
        raise ValueError(f"the narrow pass takes D <= {t.max_depth}, got {d}")
    chains = 64 if c <= 64 else 128
    tiles = -(-n // t.rows)
    blocks = -(-c // chains)
    splits = max(1, min(tiles, t.blocks_per_sm * sms // blocks))
    tiles_per_split = -(-tiles // splits)
    splits = -(-tiles // tiles_per_split)
    return GlmPlan(ldz=0, ldr=0, ldg=_round_up(d, 4), row_tiles=splits, splits=splits,
                   rows_per_split=tiles_per_split * t.rows, chain_tile=chains)


def x_row_aligned(x: Tensor) -> bool:
    """X [N, D] as K1-K4 read it: unit column stride, rows 16-byte aligned."""
    row_bytes = x.stride(0) * x.element_size()
    return (x.dim() == 2 and x.stride(1) == 1 and x.stride(0) >= x.shape[1]
            and row_bytes % 16 == 0 and x.data_ptr() % 16 == 0)


def align_rows(x: Tensor) -> Tensor:
    """X [N, D] with its rows ``ROW_BYTES`` apart: X itself when a
    contiguous X's rows are, else a view of the first D columns of a
    zero-padded [N, D'] buffer."""
    n, d = x.shape
    if x.is_contiguous() and (d * x.element_size()) % ROW_BYTES == 0 \
            and x.data_ptr() % ROW_BYTES == 0:
        return x
    buf = torch.zeros((n, _round_up(d, ROW_BYTES // x.element_size())), dtype=x.dtype,
                      device=x.device)
    buf[:, :d] = x
    return buf[:, :d]


class GlmScratch:
    """K1-K4's workspace for one FusedFamily (``build_glm_data`` makes it
    with the data, so it is freed with the data): the plan and the scratch
    tensors of the last (device, stream, C, X) it served, and the bf16
    kernels' four TMA tensor maps of that X and scratch.  A narrow plan's
    tensors are its partials alone: no staged z and no [C, N] residual, in
    a graph's capture as anywhere.  The next call
    with the same key runs after the last in stream order and reuses them;
    a call with another key replaces them.  A launch inside a CUDA-graph
    capture keeps its key's (plan, tensors, maps) in ``captured``, as long
    as the data lives: the graph replays on those buffers whatever key the
    slot serves next, and a later call with that key takes them again."""

    __slots__ = ("key", "plan", "tensors", "maps", "captured")

    def __init__(self):
        self.key = self.plan = self.tensors = self.maps = None
        self.captured = {}


class GlmKernel:
    """Wrapper of one value+grad kernel K1-K4, or K6 (``ops/logreg.py``)
    (passes in ``csrc/glm_sm90.cuh``, C entries in ``glm_vg.cu``).  One
    call launches the passes ``plan_glm`` lays out and counts one launch in
    ``launches``, and one in ``path_launches`` under its path: "narrow"
    (the f32 narrow pass) or "two_pass" (passes A and B).  A CUDA graph
    that holds a launch replays it without a call here: the lockstep NUTS
    engine adds its replays to ``launches``, and ``path_launches`` counts
    none of them (a capture counts once).

    The scratch of a call (z staged, the residual, the partials) and the
    bf16 kernels' tensor maps live in the data's ``GlmScratch``, so the
    host's work per call is two output allocations and the launches, which
    is what a launch-bound call at the floor shape pays.  Data without one
    (a FusedFamily built by hand) gets fresh scratch on every call."""

    source = "brancher_torch/csrc/glm_sm90.cuh"

    def __init__(self, name: str, family: str, x_dtype: torch.dtype, symbol: str,
                 replaces: str):
        self.name = name
        self.family = family
        self.x_dtype = x_dtype
        self.dtype = "bf16" if x_dtype == torch.bfloat16 else "f32"
        self.symbol = symbol
        self.replaces = replaces
        self.launches = 0
        self.path_launches = {"narrow": 0, "two_pass": 0}
        self._fn = self._encode = None

    def _c_function(self):
        if self._fn is None:
            from .cuda_build import load_library

            lib = load_library("glm_vg")
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.glm_sm90_tiles.argtypes = [i, p]
            lib.glm_sm90_narrow_tiles.argtypes = [p]
            for query, want in ((lambda out: lib.glm_sm90_tiles(int(self.dtype == "bf16"), out),
                                 GLM_TILES[self.dtype]),
                                (lib.glm_sm90_narrow_tiles, NARROW_TILES)):
                got = (ctypes.c_int * len(want))()
                query(ctypes.addressof(got))
                if tuple(got) != tuple(want):
                    raise RuntimeError(f"{self.name}: the library's tiles {tuple(got)} are not "
                                       f"the planner's {tuple(want)}")
            fn = getattr(lib, self.symbol)
            fn.argtypes = [p] * 8 + [f] * 3 + [p] * 6 + [i] * 11 + [p]
            fn.restype = ctypes.c_int
            lib.glm_sm90_encode_maps.argtypes = [p, i, p, i, p, i, i, i, i, p]
            lib.glm_sm90_encode_maps.restype = ctypes.c_int
            self._fn, self._encode = fn, lib.glm_sm90_encode_maps
        return self._fn

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
            layout_ok = x_row_aligned(t) if field == "x" else t.is_contiguous()
            if tuple(t.shape) != shape or t.device != z.device or not layout_ok:
                raise ValueError(
                    f"{self.name}: {field} must be a {shape} tensor on {z.device} "
                    f"laid out as build_glm_data makes it, got {tuple(t.shape)} on {t.device}")
            if field != "x" and t.dtype != torch.float32:
                raise TypeError(f"{self.name}: {field} must be float32")
        if c == 0 or n == 0 or d == 0:
            raise ValueError(f"{self.name}: empty input (C={c}, N={n}, D={d})")

    def _fill(self, scratch: GlmScratch, key: tuple, x: Tensor, c: int,
              plan: Optional[GlmPlan] = None):
        """Plan (``plan_glm``, unless ``plan`` is given), allocate and (bf16)
        encode ``scratch`` for ``key``.  A
        tensor map holds the pointer, shape and strides it was encoded for,
        so the key holds X's pointer and stride, and the scratch is new with
        it."""
        device, n, d = x.device, x.shape[0], x.shape[1]
        if plan is None:
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            plan = plan_glm(c, n, d, self.dtype, sms)
        shapes = plan.scratch_shapes(c)
        zs = resid = None
        if not plan.narrow:
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
        """The residual [C, N] of one launch of passes A and B, in the
        operand type (for the bf16 kernels with its bf16 rounding): what the
        second product read.  The narrow pass keeps none."""
        resid = self._launch(z, data)[2]
        if resid is None:
            raise ValueError(f"{self.name}: the narrow pass at D={z.shape[1]} keeps no residual")
        return resid.clone()

    def _launch(self, z: Tensor, data: FusedFamily,
                plan: Optional[GlmPlan] = None) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
        """One launch: (val, grad, the residual scratch or None).  ``plan``
        replaces ``plan_glm``'s (a measurement of another path at the same
        shape); it is part of the scratch's key, so calls with it reuse
        their scratch and a call without it plans anew."""
        if z.device.type != "cuda":
            raise RuntimeError(f"{self.name} runs on CUDA tensors, got {z.device}")
        self._check(z, data)
        fn = self._c_function()
        c, d = z.shape
        x = data.x
        n = x.shape[0]
        f32 = dict(device=z.device, dtype=torch.float32)
        val, grad = torch.empty((c,), **f32), torch.empty((c, d), **f32)
        scratch = data.scratch if data.scratch is not None else GlmScratch()
        u_ptr = None if data.u is None else data.u.data_ptr()
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            key = (z.device, stream, c, x.data_ptr(), x.stride(0), n, d, plan)
            entry = scratch.captured.get(key)
            if entry is None:
                if scratch.key != key:
                    self._fill(scratch, key, x, c, plan)
                entry = scratch.plan, scratch.tensors, scratch.maps
                if torch.cuda.is_current_stream_capturing():
                    scratch.captured[key] = entry
            plan, (zs, resid, ll_part, g_part), maps = entry
            maps = None if maps is None else ctypes.addressof(maps)
            ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
            err = fn(z.data_ptr(), x.data_ptr(), maps, data.y.data_ptr(), data.b.data_ptr(),
                     data.prior_mean.data_ptr(), data.prior_inv_var.data_ptr(), u_ptr,
                     float(data.c0), float(data.ll_scale), float(n), val.data_ptr(),
                     grad.data_ptr(), ptr(zs), ptr(resid), ll_part.data_ptr(),
                     g_part.data_ptr(), c, n, d, x.stride(0), plan.ldz, plan.ldr, plan.ldg,
                     plan.row_tiles, plan.splits, plan.rows_per_split, plan.chain_tile, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        self.path_launches["narrow" if plan.narrow else "two_pass"] += 1
        return val, grad, None if resid is None else resid[:, :n]


_SRC = "brancher_tpu/ops/pallas_glm.py"
KERNELS: Dict[str, GlmKernel] = {
    k.name: k for k in (
        GlmKernel("glm_bernoulli_f32", "bernoulli_logit", torch.float32,
                  "glm_vg_bernoulli_f32", f"{_SRC}:179 _bern_kernel"),
        GlmKernel("glm_bernoulli_bf16", "bernoulli_logit", torch.bfloat16,
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
    cast the design matrix to bf16.  X's rows start ``ROW_BYTES`` apart,
    as K1-K4 read them best (``align_rows``: a padded buffer when D is not
    a multiple of 128 bytes), unless ``align_x`` is False, for a reader
    that takes X contiguous (K5).  The data carries K1-K4's scratch."""
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
    if align_x:
        xd = align_rows(xd)
    return FusedFamily(
        family, xd, vec(y), vec(b), None if u is None else vec(u), float(c0),
        vec(prior_mean), vec(prior_inv_var), float(ll_scale), GlmScratch(),
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
    elif isinstance(dist, AutoRegressive):
        # AR(p): the lag matrix of the observed series is X, the series
        # past its first p values is y (JAX pallas_glm.py:865-890)
        p = dist.order
        lags = AutoRegressive.lags(y_val, p).contiguous()  # [T - p, p]
        y_eff = y_val[p:].contiguous()
        m = y_eff.shape[0]
        if not _scale_is_shared(obs_params_f, "noise_scale", dim, dev):
            return None

        def f_loc(zf):
            pr_ = obs_params_f(zf)
            bias = _per_row(pr_["bias"], m) if "bias" in pr_ else 0.0
            return lags @ torch.atleast_1d(pr_["coefficients"]) + bias

        def f_logscale(zf):
            return torch.log(torch.atleast_1d(obs_params_f(zf)["noise_scale"]).reshape(-1)[0:1])

        fam = _extract_normal_learned(f_loc, f_logscale, y_eff, dim, dev,
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
    elif isinstance(dist, Categorical):
        if "logits" not in obs_var.links:
            return None
        y_int = obs_var._observed.to(torch.int64).reshape(-1).cpu().numpy()
        n = int(y_int.shape[0])
        with torch.no_grad():
            num_classes = int(obs_params_f(torch.zeros(dim, device=dev))["logits"].shape[-1])
        if n * num_classes * dim > 5e7:
            return None  # the probe matrix would not fit comfortably

        def f_logits_flat(zf):
            lg = obs_params_f(zf)["logits"]
            if lg.numel() not in (num_classes, n * num_classes):
                raise _NotAGlm(f"logits of shape {tuple(lg.shape)} over {n} rows")
            return torch.broadcast_to(lg, (n, num_classes)).reshape(-1)

        ab = _affine_probe(f_logits_flat, dim, dev)
        if ab is None:
            return None
        fam = _extract_categorical(ab[0].cpu().numpy(), ab[1].cpu().numpy(), y_int, n,
                                   num_classes, dim, prior_mean, prior_inv_var, ll_scale, dev)
    else:
        return None
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
    "normal_vg_reference", "normal_vg_reference_bf16",
    "residual_reference", "residual_weight", "grad_given_residual", "bf16_rounding_flips",
    "bf16_residual_readings",
    "GlmKernel", "GlmScratch", "KERNELS", "kernel_for", "build_glm_data",
    "GlmTiles", "GLM_TILES", "GlmPlan", "plan_glm", "plan_two_pass", "plan_narrow",
    "NarrowTiles", "NARROW_TILES", "NARROW_MAX_D", "takes_narrow_pass",
    "ROW_BYTES", "align_rows", "x_row_aligned",
    "build_glm_vg", "FusedFamily", "recognize_fused_family",
    "categorical_vg_reference", "CategoricalFusedFamily",
    "glm_flops", "glm_bytes",
]
