"""Fused GLM value+grad: plain versions, CUDA kernel wrappers, recognizer.

Counterpart of ``brancher_tpu/ops/pallas_glm.py``.  Two families cover
the dense likelihoods of the model zoo:

  * ``bernoulli_logit``  y_n ~ Bernoulli(sigmoid(x_n.z + b_n))
  * ``normal_learned``   y_n ~ N(x_n.z + b_n, exp(u.z + c0))

For each family and design-matrix type (f32, bf16) there is a plain
PyTorch version (``*_vg_reference*``) and a kernel written by hand in CUDA
(``csrc/glm_vg.cu``, one template, four instantiations K1-K4; a fifth,
K6, serves ``ops/logreg.py``).  The
wrappers (``GlmKernel``) take a tensor on the CPU to the plain version and
a tensor on a CUDA device to the kernel; there is no fallback from the
kernel to the plain version.

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
            if tuple(t.shape) != shape or t.device != z.device or not t.is_contiguous():
                raise ValueError(
                    f"{self.name}: {field} must be a contiguous {shape} tensor on "
                    f"{z.device}, got {tuple(t.shape)} on {t.device}")
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
                   ll_scale=1.0, dtype="f32", device=None) -> FusedFamily:
    """Prepare the data of a fused potential once: move it to ``device``
    (default ``config.device``), make it contiguous, and for dtype='bf16'
    cast the design matrix to bf16 — the only copy of X the build makes."""
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
    return FusedFamily(
        family, xd, vec(y), vec(b), None if u is None else vec(u), float(c0),
        vec(prior_mean), vec(prior_inv_var), float(ll_scale),
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
    "normal_vg_reference", "normal_vg_reference_bf16",
    "GlmKernel", "KERNELS", "kernel_for", "build_glm_data",
    "build_glm_vg", "FusedFamily", "recognize_fused_family",
    "glm_flops", "glm_bytes",
]
