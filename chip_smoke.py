#!/usr/bin/env python3
"""Drive brancher_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --phases 1,2   # a subset (no "ok" line then)

Phases (each prints one or more JSON lines tagged "phase"):
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the builds of brancher_torch/csrc/glm_vg.cu (with
     the header glm_sm90.cuh it includes) and leapfrog.cu (one nvcc each,
     started together) with ptxas's register, spill and shared-memory
     lines;
  2. every kernel against its plain PyTorch version: K1-K4 at the floor
     shape (C=1024, N=1000, D=32), the conjugate shape (C=64, N=20, D=1),
     the MXU-scale GLM shape (C=256, N=131072, D=1024) and a ragged shape
     (C=100, N=1037, D=33: no axis a multiple of 8), K3/K4 also at phase
     5's linear-Gaussian shape (C=256, N=131072, D=1025); K5 (the fused
     leapfrog) for both families at the floor and conjugate shapes with 1,
     8 and 32 steps; K6 (logreg) at the floor and MXU shapes.  Each row has
     errors, a control, the determinism check, the kernel's and the plain
     version's median ms, the bound's ms and TFLOP/s; the value+grad rows
     also the median ms of the two products alone through cuBLAS
     (matmul_pair_ms);
  3. vectorized NUTS at the floor config: make_logreg_data(1000, 32) ->
     logistic_regression_model -> sample(NUTS(max_depth=8), 500 warmup,
     1000 draws, 1024 chains) with fused_potential "auto" (K1), "bf16" (K2)
     and "off" (autodiff, the yardstick), fewer draws for the last two;
  4. NUTS on the conjugate model with "auto" (K3) and "bf16" (K4) against
     its closed-form posterior;
  5. the MXU-scale logistic regression (N=131072, D=1024, 256 chains) with
     "auto" (K1) and "bf16" (K2), and the peak card memory of the
     recognizer's prior probe with the whole log density and with the
     prior alone; then a linear-Gaussian regression on the same X (w ~
     N(0, 1) [1024], sigma ~ LogNormal(0, 0.5), y ~ N(X w, sigma): D=1025)
     with "auto" (K3) and "bf16" (K4);
  6. ChEES at the floor config (500 warmup, 1000 draws, 1024 chains) three
     ways: fused_leapfrog=True (K5), a loop of K1, and value_and_grad_fn=
     K6; posterior means against phase 3's "auto" run;
  7. HMC with fused_leapfrog=True: HMC(num_integration_steps=16) on the
     conjugate model (K5 on normal_learned), against the closed form; and
     HMC(num_integration_steps=32) on the floor model (1024 chains, 100
     warmup + 200 draws: K5 on bernoulli_logit with up to 32 steps a
     transition), posterior means against phase 3's "auto" run, with the
     sampler's ms per transition;
  8. the {"kernels": [...]} summary (K3 and K4 once for each of their two
     paths, K5 once for each of its three),
     the card's name and power limit, and
     the last line {"ok": true, "device": {...}}.

Every launch counter is set to 0 just before each sample() run and read
just after it; a run whose kernels did not launch as expected (the
value+grad kernel once per value+grad call, K5 once per transition)
fails the script.  Any failed check raises: the script then exits
non-zero and prints no "ok" line.  Without CUDA, or without the
brancher_torch package beside it, it exits 2 at once.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent

# published H100 SXM peaks (dense): HBM bytes/s, f32 CUDA-core and bf16
# tensor-core operations/s; the card's power limit is printed beside them
PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12}

SHAPES = {
    "floor": (1024, 1000, 32),
    "conjugate": (64, 20, 1),
    "mxu": (256, 131072, 1024),
    "ragged": (100, 1037, 33),
    "linreg": (256, 131072, 1025),
}
# phase 5's linear-Gaussian regression (z = [sigma, w]): K3/K4 only
NORMAL_ONLY_SHAPES = ("linreg",)
LEAPFROG_SHAPES = ("floor", "conjugate")
LEAPFROG_STEPS = (1, 8, 32)
LOGREG_SHAPES = ("floor", "mxu")
SOURCES = ("glm_vg", "leapfrog")
# each value+grad kernel's shape on its main path (phase 3 and 6 for K1,
# K2 and K6)
MAIN_SHAPE = {"glm_bernoulli_f32": "floor", "glm_bernoulli_bf16": "floor", "logreg_f32": "floor"}
# K3/K4 run on two main paths, one entry each in the summary: (section and
# run of RESULTS, phase-2 shape)
NORMAL_PATHS = {"glm_normal_f32": ((("conjugate", "auto"), "conjugate"),
                                   (("mxu_linreg", "auto"), "linreg")),
                "glm_normal_bf16": ((("conjugate", "bf16"), "conjugate"),
                                    (("mxu_linreg", "bf16"), "linreg"))}
# K5 runs on three main paths, one entry each in the summary: (section and
# run of RESULTS, phase-2 shape, family, phase-2 step count; None: the one
# nearest the run's leapfrogs per draw)
LEAPFROG_PATHS = ((("chees", "fused"), "floor", "bernoulli_logit", None),
                  (("hmc_conjugate", "fused"), "conjugate", "normal_learned", None),
                  (("hmc_floor", "fused"), "floor", "bernoulli_logit", 32))
HMC_FLOOR_STEPS = 32
# Limit on max|kernel - plain| / max(max|plain|, 1), for val and grad.  The
# kernel and its plain version differ only in summation order: the worst
# reading on an H100 was 9.4e-7 (PERF.md).  For bf16 the product of two
# bf16 values is exact in f32, so the sums that feed the bf16 rounding of
# the residual agree as closely.  The limit sits above that reading and
# below the controls that each row also measures: the f32 plain version
# with TF32 products, and for bf16 the plain version without the bf16
# rounding of z and the residual.  A kernel that did either would fail.
TOL = 1e-5
# The bf16 kernels (K2, K4) sum their linear predictor (logit or loc) on
# the tensor cores, in another order than cuBLAS's f32 product in the plain
# version, and cuBLAS's own order changes with the shape.  Where the last
# bits of the predictor move the f32 residual across a bf16 rounding
# boundary, the kernel's bf16 residual is another bf16 value (a tie), and
# the gradient of its chain moves by that step times ll_scale times the
# chain's e2 (normal_learned) times the row of X: up to 2e-5 of the
# gradient's scale for one tie at the floor.  So a bf16 row (_bf16_ok)
# holds:
#   - its value to TOL;
#   - its gradient to TOL plus the bound of its ties' move
#     (glm.bf16_residual_readings' flip_allowance_rel, 0 without ties);
#   - its gradient to TOL against the plain formula applied to the kernel's
#     own bf16 residual;
#   - every differing residual to a tie (glm.TIE_UNITS of the residual's f32
#     precision from rounding to the kernel's value), at most FLIP_SHARE of
#     the residuals.  K2 on an H100 read 1.7e-5 at the MXU shape.  A Normal
#     residual near 0, where bf16's step is finest, flips for the same last
#     bits of loc, so K4's share is higher: 1.77e-4 at the linear-Gaussian
#     shape on an H100, each tie within 1.125 units (PERF.md).
# The unrounded control goes through the same gate and must fail it.
FLIP_SHARE = {"bernoulli_logit": 1e-4, "normal_learned": 1e-3}
# The same quantity for K5's z, r, val and grad after a trajectory.  A
# trajectory carries each step's rounding into the next, so the error
# grows with the step count: on an H100 the worst reading was 3.6e-6
# (normal_learned, floor shape, 32 steps; PERF.md).  The limit sits 8x
# above it and below every floor-shape TF32 control (2.1e-4 to 1.9e-3 at
# 1 to 32 steps); at D=1 (conjugate) the control uses no tensor cores.
TOL_LEAPFROG = 3e-5
LEAPFROG_EPS = 0.05

RESULTS: dict = {}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 11, warm_ms: float = 50.0) -> float:
    """Median ms of ``reps`` launches enqueued back to back, each between
    two CUDA events (so host time between launches hides behind the card
    unless the host is the slower one), after at least ``warm_ms`` of
    calls so that the card's clocks have settled under the load."""
    import torch

    t0 = time.perf_counter()
    for i in range(10**6):
        fn()
        torch.cuda.synchronize()
        if i >= 1 and (time.perf_counter() - t0) * 1e3 >= warm_ms:
            break
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def _bound(nbytes: int, flops: int, dtype: str = "f32") -> dict:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_OPS[dtype] * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _tflops(row: dict) -> float:
    return row["flops"] / (row["ms"] * 1e-3) / 1e12


def _all_kernels():
    from brancher_torch.ops import kernel_wrappers

    return kernel_wrappers()


def _reset_launches() -> None:
    for k in _all_kernels().values():
        k.launches = 0


# ---------------------------------------------------------------------------
def phase_environment():
    import torch
    from brancher_torch.ops import cuda_build

    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, together
        list(pool.map(cuda_build.load_library, SOURCES))
    build_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    env = {
        "phase": 1, "nvidia_smi": smi, "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "peak_bytes_per_s": PEAK_BYTES, "peak_ops_per_s": PEAK_OPS,
        "build_seconds": round(build_s, 3),
        "headers": {name: [p.name for p in cuda_build.included_headers(name)] for name in SOURCES},
        "ptxas": {name: [ln.strip() for ln in (cuda_build.BUILD_DIR / f"{name}.log")
                         .read_text().splitlines()
                         if "registers" in ln or "Compiling" in ln or "spill" in ln]
                  for name in SOURCES},
    }
    RESULTS["environment"] = env
    emit(env)


def _rel(got, ref) -> float:
    """max|got - ref| over max(max|ref|, 1): the quantity the limits bound."""
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def _glm_inputs(c, n, d, family, gen):
    import torch

    dev = "cuda"
    x = torch.randn((n, d), generator=gen, device=dev) / d**0.5
    if family == "bernoulli_logit":
        y = (torch.rand((n,), generator=gen, device=dev) < 0.5).float()
    else:
        y = torch.randn((n,), generator=gen, device=dev)
    b = 0.3 * torch.randn((n,), generator=gen, device=dev)
    z = torch.randn((c, d), generator=gen, device=dev)
    m = torch.linspace(-1, 1, d, device=dev)
    iv = torch.linspace(0.5, 2.0, d, device=dev)
    u = torch.zeros(d, device=dev)
    u[-1] = 0.1
    return x, y, b, z, m, iv, u


def _glm_rows(gen, per_kernel):
    import torch
    from brancher_torch.ops import glm

    for shape_name, (c, n, d) in SHAPES.items():
        for family in ("bernoulli_logit", "normal_learned"):
            if family != "normal_learned" and shape_name in NORMAL_ONLY_SHAPES:
                continue
            x, y, b, z, m, iv, u = _glm_inputs(c, n, d, family, gen)
            for dtype in ("f32", "bf16"):
                data = glm.build_glm_data(
                    family, x, y, b, m, iv, u=u if family == "normal_learned" else None,
                    c0=-0.3, ll_scale=1.3, dtype=dtype, device="cuda")
                kernel = glm.kernel_for(family, dtype)
                v, g = kernel(z, data)
                v2, g2 = kernel(z, data)
                v_ref, g_ref = data.plain(z)
                if dtype == "f32":  # control: the products in TF32
                    torch.backends.cuda.matmul.allow_tf32 = True
                    v_ctl, g_ctl = data.plain(z)
                    torch.backends.cuda.matmul.allow_tf32 = False
                else:  # control: z and the residual not rounded to bf16
                    v_ctl, g_ctl = data._replace(x=data.x.float()).plain(z)
                torch.cuda.synchronize()
                err = {
                    "val_max_abs": float((v - v_ref).abs().max()),
                    "grad_max_abs": float((g - g_ref).abs().max()),
                    "val_max_rel": _rel(v, v_ref), "grad_max_rel": _rel(g, g_ref),
                }
                control = {
                    "control": "tf32" if dtype == "f32" else "unrounded_bf16",
                    "control_val_rel": _rel(v_ctl, v_ref), "control_grad_rel": _rel(g_ctl, g_ref),
                }
                ties = dtype == "bf16"
                if ties:
                    err.update(glm.bf16_residual_readings(g, kernel.residual(z, data), z, data, g_ref))
                    err["grad_limit_rel"] = TOL + err["flip_allowance_rel"]
                    r_ctl = glm.residual_reference(z, data._replace(x=data.x.float()))
                    ctl = glm.bf16_residual_readings(g_ctl, r_ctl, z, data, g_ref)
                    ctl["val_max_rel"] = control["control_val_rel"]
                    control.update({f"control_{k}": ctl[k] for k in (
                        "resid_flips", "flips_legal", "flip_allowance_rel")})
                    control["control_passes_gate"] = _bf16_ok(ctl, family)
                ok = ((_bf16_ok(err, family) if ties
                       else err["val_max_rel"] <= TOL and err["grad_max_rel"] <= TOL)
                      and bool(torch.isfinite(v).all()) and bool(torch.isfinite(g).all()))
                deterministic = bool(torch.equal(v, v2) and torch.equal(g, g2))
                ms = time_ms(lambda: kernel(z, data))
                plain_ms = time_ms(lambda: data.plain(z))
                if dtype == "bf16":
                    z16, x16 = z.to(torch.bfloat16), data.x
                    r16 = torch.zeros((c, n), device="cuda", dtype=torch.bfloat16)
                    pair = lambda: (z16 @ x16.T, r16 @ x16)
                else:
                    r32 = torch.zeros((c, n), device="cuda")
                    pair = lambda: (z @ data.x.T, r32 @ data.x)
                matmul_ms = time_ms(pair)
                row = {
                    "phase": 2, "kernel": kernel.name, "shape": shape_name, "C": c, "N": n, "D": d,
                    **err, **control, "tolerance_rel": TOL, "ok": ok, "deterministic": deterministic,
                    **({"tie_units_limit": glm.TIE_UNITS, "flip_share_limit": FLIP_SHARE[family]}
                       if ties else {}),
                    "ms": ms, "plain_ms": plain_ms, "matmul_pair_ms": matmul_ms, "library_ms": None,
                    **_bound(glm.glm_bytes(c, n, d, 2 if dtype == "bf16" else 4, family),
                             glm.glm_flops(c, n, d), dtype),
                }
                row["tflops"] = _tflops(row)
                emit(row)
                per_kernel[kernel.name].append(row)
                check(ok, f"{kernel.name} at {shape_name} disagrees with its plain version: {err}")
                check(not (ties and control["control_passes_gate"]),
                      f"{kernel.name} at {shape_name}: the unrounded control passes the bf16 gate")
                check(deterministic, f"{kernel.name} at {shape_name} is not bit-reproducible")
            del x, y, b, z, data
            torch.cuda.empty_cache()


def _bf16_ok(r: dict, family: str) -> bool:
    """The bf16 kernels' gate on glm.bf16_residual_readings and the value's
    error (see FLIP_SHARE)."""
    return (r["val_max_rel"] <= TOL and r["grad_max_rel"] <= TOL + r["flip_allowance_rel"]
            and r["grad_given_resid_rel"] <= TOL and r["flips_legal"]
            and r["flip_share"] <= FLIP_SHARE[family])


def _leapfrog_rows(gen, per_kernel):
    import torch
    from brancher_torch.ops import glm, leapfrog as lf

    for shape_name in LEAPFROG_SHAPES:
        c, n, d = SHAPES[shape_name]
        for family in ("bernoulli_logit", "normal_learned"):
            x, y, b, z, m, iv, u = _glm_inputs(c, n, d, family, gen)
            u_fam = u if family == "normal_learned" else None
            fused = lf.build_fused_leapfrog(family, x, y, b, m, iv, u=u_fam, c0=-0.3,
                                            ll_scale=1.3, device="cuda")
            check(fused is not None, f"{family} at {shape_name} fails K5's size gate")
            data = fused.data
            r = torch.randn((c, d), generator=gen, device="cuda")
            _, g = data.plain(z)
            im = torch.linspace(0.5, 1.5, d, device="cuda")
            eps = torch.tensor(LEAPFROG_EPS, device="cuda")
            plain = lf.reference_leapfrog(data.plain)  # K5's plain version
            for n_steps in LEAPFROG_STEPS:
                steps_t = torch.tensor(n_steps, dtype=torch.int32, device="cuda")
                out = fused(z, r, g, eps, im, steps_t)
                out2 = fused(z, r, g, eps, im, steps_t)
                ref = plain(z, r, g, eps, im, n_steps)
                torch.backends.cuda.matmul.allow_tf32 = True  # control: TF32 products
                ctl = plain(z, r, g, eps, im, n_steps)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.cuda.synchronize()
                names = ("z", "r", "val", "grad")
                err = {f"{k}_max_rel": _rel(a, bb) for k, a, bb in zip(names, out, ref)}
                err["max_abs"] = max(float((a - bb).abs().max()) for a, bb in zip(out, ref))
                control = {"control": "tf32",
                           "control_max_rel": max(_rel(a, bb) for a, bb in zip(ctl, ref))}
                worst = max(err[f"{k}_max_rel"] for k in names)
                ok = worst <= TOL_LEAPFROG and all(bool(torch.isfinite(t).all()) for t in out)
                deterministic = all(torch.equal(a, bb) for a, bb in zip(out, out2))
                ms = time_ms(lambda: fused(z, r, g, eps, im, steps_t))
                plain_ms = time_ms(lambda: plain(z, r, g, eps, im, n_steps))
                row = {
                    "phase": 2, "kernel": lf.LEAPFROG.name, "family": family, "shape": shape_name,
                    "C": c, "N": n, "D": d, "n_steps": n_steps, "plan": fused.plan(z)._asdict(),
                    **err, "max_rel": worst,
                    **control, "tolerance_rel": TOL_LEAPFROG, "ok": ok,
                    "deterministic": deterministic, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None,
                    **_bound(lf.leapfrog_bytes(c, n, d, family), lf.leapfrog_flops(c, n, d, n_steps)),
                }
                row["tflops"] = _tflops(row)
                emit(row)
                per_kernel[lf.LEAPFROG.name].append(row)
                check(ok, f"K5 {family} at {shape_name}, {n_steps} steps, disagrees: {err}")
                check(deterministic, f"K5 {family} at {shape_name} is not bit-reproducible")
            del x, y, b, z, data, fused
            torch.cuda.empty_cache()


def _logreg_rows(gen, per_kernel):
    import torch
    from brancher_torch.ops import glm, logreg

    for shape_name in LOGREG_SHAPES:
        c, n, d = SHAPES[shape_name]
        x = torch.randn((n, d), generator=gen, device="cuda") / d**0.5
        y = (torch.rand((n,), generator=gen, device="cuda") < 0.5).float()
        w = torch.randn((c, d), generator=gen, device="cuda")
        r32 = torch.zeros((c, n), device="cuda")
        v, g = logreg.logreg_value_and_grad(w, x, y, 1.5)
        v2, g2 = logreg.logreg_value_and_grad(w, x, y, 1.5)
        v_ref, g_ref = logreg.logreg_value_and_grad_reference(w, x, y, 1.5)
        torch.backends.cuda.matmul.allow_tf32 = True
        v_ctl, g_ctl = logreg.logreg_value_and_grad_reference(w, x, y, 1.5)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        err = {"val_max_abs": float((v - v_ref).abs().max()),
               "grad_max_abs": float((g - g_ref).abs().max()),
               "val_max_rel": _rel(v, v_ref), "grad_max_rel": _rel(g, g_ref)}
        ok = (err["val_max_rel"] <= TOL and err["grad_max_rel"] <= TOL
              and bool(torch.isfinite(v).all()) and bool(torch.isfinite(g).all()))
        deterministic = bool(torch.equal(v, v2) and torch.equal(g, g2))
        row = {
            "phase": 2, "kernel": logreg.LOGREG.name, "shape": shape_name, "C": c, "N": n, "D": d,
            **err, "control": "tf32", "control_val_rel": _rel(v_ctl, v_ref),
            "control_grad_rel": _rel(g_ctl, g_ref), "tolerance_rel": TOL, "ok": ok,
            "deterministic": deterministic,
            "ms": time_ms(lambda: logreg.logreg_value_and_grad(w, x, y, 1.5)),
            "plain_ms": time_ms(lambda: logreg.logreg_value_and_grad_reference(w, x, y, 1.5)),
            "matmul_pair_ms": time_ms(lambda: (w @ x.T, r32 @ x)), "library_ms": None,
            # X, y, w read once; val and grad written once
            **_bound(n * d * 4 + n * 4 + (2 * c * d + c) * 4, glm.glm_flops(c, n, d)),
        }
        row["tflops"] = _tflops(row)
        emit(row)
        per_kernel[logreg.LOGREG.name].append(row)
        check(ok, f"K6 at {shape_name} disagrees with its plain version: {err}")
        check(deterministic, f"K6 at {shape_name} is not bit-reproducible")
        del x, y, w, r32
        torch.cuda.empty_cache()


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {k: [] for k in _all_kernels()}
    _glm_rows(gen, per_kernel)
    _leapfrog_rows(gen, per_kernel)
    _logreg_rows(gen, per_kernel)
    _reset_launches()  # comparison launches do not count for the main path
    RESULTS["kernels"] = per_kernel


def _run_sample(model, tag, kernel_name, transition_kernel=None, **kw):
    """One sample() run with every launch counter at 0 before it; checks
    that the value+grad kernel ran once per value+grad call, the
    trajectory kernel (K5) once per transition, and no other kernel."""
    import torch
    from brancher_torch.inference import sample

    _reset_launches()
    gc.collect()  # an earlier phase's tensors held in reference cycles
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sample(model, device="cuda", **kw)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in _all_kernels().items()}
    d = res.diagnostics
    calls = d["value_and_grad_calls"]
    transitions = kw.get("num_warmup", 0) + kw["num_samples"]
    for name, count in launches.items():
        want = calls if name == kernel_name else transitions if name == transition_kernel else 0
        check(count == want, f"{tag}: {name} launched {count} times, expected {want}")
    check(kernel_name is None or calls > 0, f"{tag}: no value+grad call")
    check(d["fused_leapfrog"] == (transition_kernel is not None),
          f"{tag}: fused_leapfrog diagnostic is {d['fused_leapfrog']}")
    draws = res.stats["num_steps"].shape[1]
    steps = int(res.stats["num_steps"][0].sum())
    info = {
        "run": tag, "kernel": kernel_name, "transition_kernel": transition_kernel,
        "launches": launches, "fused_family": d["fused_family"], "fused_dtype": d["fused_dtype"],
        "fused_leapfrog": d["fused_leapfrog"],
        "sampler_seconds": d["sampler_seconds"], "wall_seconds": wall,
        "value_and_grad_calls": calls, "warmup_leaf_iterations": d.get("warmup_leapfrog"),
        "sampling_leaf_iterations": steps, "leaves_per_draw": steps / draws,
        "host_syncs": d["host_syncs"], "host_syncs_per_draw": d["host_syncs"] / transitions,
        "sampler_ms_per_vg_call": d["sampler_seconds"] * 1e3 / max(calls, 1),
        "divergences": d["num_divergences"], "mean_accept": d["mean_accept_prob"],
        "step_size": float(d["step_size"]),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if "trajectory_length" in d:
        info["trajectory_length"] = float(d["trajectory_length"])
    return res, info


def _post_stats(res, name):
    import numpy as np

    x = res.samples[name].double().cpu().numpy()
    ess = np.asarray(res.diagnostics["ess"][name], np.float64)
    mean = x.mean(axis=(0, 1))
    sd = x.std(axis=(0, 1))
    return mean, sd, ess, np.asarray(res.diagnostics["r_hat"][name], np.float64)


def _mcse_compare(phase, tag, ref, run, section):
    import numpy as np

    (m0, s0, e0), (m1, s1, e1) = ref, run
    z = np.abs(m1 - m0) / np.sqrt(s0**2 / e0 + s1**2 / e1)
    line = {"phase": phase, "compare": tag, "max_abs_diff": float(np.abs(m1 - m0).max()),
            "max_diff_in_mcse": float(z.max())}
    emit(line)
    RESULTS[section][tag] = line
    check(float(z.max()) < 5.0, f"{tag}: posterior means differ by {z.max():.2f} MCSE")


def _floor_model():
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    x, y, _ = make_logreg_data(1000, 32, seed=0)
    return x, y, logistic_regression_model(x, y)


def phase_floor():
    import numpy as np
    from brancher_torch.inference import NUTS

    _, _, model = _floor_model()
    base = dict(kernel=NUTS(max_depth=8), num_warmup=500, num_chains=1024, key=0)
    runs = {}
    for tag, fp, kname, draws in (("auto", "auto", "glm_bernoulli_f32", 1000),
                                  ("bf16", "bf16", "glm_bernoulli_bf16", 250),
                                  ("off", "off", None, 250)):
        res, info = _run_sample(model, f"floor/{tag}", kname, fused_potential=fp,
                                num_samples=draws, **base)
        mean, sd, ess, rhat = _post_stats(res, "w")
        info.update({
            "phase": 3, "num_samples": draws, "min_ess": float(ess.min()),
            "ess_per_second": float(ess.min()) / info["sampler_seconds"],
            "max_rhat": float(rhat.max()),
        })
        if fp != "off":
            check(info["fused_family"] == "bernoulli_logit", f"floor/{tag}: family {info['fused_family']}")
        check(info["max_rhat"] < 1.01, f"floor/{tag}: max R-hat {info['max_rhat']}")
        check(bool(np.isfinite(mean).all()) and mean.shape == (32,), f"floor/{tag}: bad means")
        runs[tag] = (mean, sd, ess)
        emit(info)
        RESULTS.setdefault("floor", {})[tag] = info
    for tag in ("auto", "bf16"):
        _mcse_compare(3, f"{tag} vs off", runs["off"], runs[tag], "floor")
    RESULTS["floor_auto_moments"] = runs["auto"]


def phase_conjugate():
    from brancher_torch.inference import NUTS
    from brancher_torch.models import conjugate_normal_model

    model, info = conjugate_normal_model()
    for tag, fp, kname in (("auto", "auto", "glm_normal_f32"), ("bf16", "bf16", "glm_normal_bf16")):
        res, run = _run_sample(model, f"conjugate/{tag}", kname, fused_potential=fp,
                               kernel=NUTS(max_depth=8), num_warmup=500, num_samples=1000,
                               num_chains=64, key=1)
        _check_conjugate(res, run, info, 4, f"conjugate/{tag}")
        RESULTS.setdefault("conjugate", {})[tag] = run


def _check_conjugate(res, run, info, phase, tag):
    import numpy as np

    mean, sd, ess, rhat = _post_stats(res, "mu")
    mcse = float(sd / np.sqrt(ess))
    var_rel = float(sd**2 / info["post_var"] - 1.0)
    run.update({
        "phase": phase, "post_mean": float(mean), "closed_form_mean": float(info["post_mean"]),
        "mean_diff_in_mcse": abs(float(mean) - float(info["post_mean"])) / mcse,
        "post_var": float(sd**2), "closed_form_var": float(info["post_var"]),
        "var_rel_err": var_rel, "var_rel_tol": float(5 * np.sqrt(2.0 / ess)),
        "ess": float(ess), "max_rhat": float(rhat),
    })
    emit(run)
    check(run["fused_family"] == "normal_learned", f"{tag}: family {run['fused_family']}")
    check(run["mean_diff_in_mcse"] < 5.0, f"{tag}: mean off by {run['mean_diff_in_mcse']:.2f} MCSE")
    check(abs(var_rel) < run["var_rel_tol"], f"{tag}: variance off by {var_rel:.4f}")


def _probe_peak_gib(comp, prior_f) -> float:
    """Peak card memory (GiB above what was allocated) of the recognizer's
    diagonal-Gaussian probe of ``prior_f``."""
    import torch
    from brancher_torch.ops import glm

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    check(glm._diag_gaussian_prior(prior_f, comp.dim, comp.device) is not None,
          "the MXU-scale prior is not a diagonal Gaussian")
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def _linreg_model(x, w_true):
    """The linear-Gaussian regression of phase 5, from the ported DSL:
    w ~ N(0, 1) [D], sigma ~ LogNormal(0, 0.5), y ~ N(X w, sigma) with y =
    X w_true + 0.5 noise.  Its z is [sigma, w] (sorted keys), D + 1 wide."""
    import numpy as np
    import torch
    import brancher_torch as BT
    import brancher_torch.functions as BF

    d = x.shape[1]
    y = x @ w_true + 0.5 * np.random.RandomState(1).normal(size=x.shape[0]).astype(np.float32)
    w = BT.NormalVariable(torch.zeros(d), torch.ones(d), "w")
    sigma = BT.LogNormalVariable(0.0, 0.5, "sigma")
    yv = BT.NormalVariable(BF.matmul(torch.as_tensor(x), w), sigma, "y")
    yv.observe(y.astype(np.float32))
    return BT.ProbabilisticModel([yv])


def _mxu_runs(model, section, runs, family, setup, n, w_dim):
    """Phase 5's sample() runs of one model: 256 chains, NUTS(max_depth=5),
    10 warmup + 10 draws; finite draws of w [256, 10, w_dim] and the
    family.  Each run's D is its z's width."""
    import numpy as np
    from brancher_torch.inference import NUTS

    for tag, fp, kname in runs:
        res, run = _run_sample(model, f"{section}/{tag}", kname, fused_potential=fp,
                               kernel=NUTS(max_depth=5), num_warmup=10, num_samples=10,
                               num_chains=256, key=2)
        w = res.samples["w"]
        check(tuple(w.shape) == (256, 10, w_dim), f"{section}/{tag}: samples shape {tuple(w.shape)}")
        finite = all(bool(np.isfinite(v.float().cpu().numpy()).all()) for v in res.samples.values())
        check(finite, f"{section}/{tag}: non-finite samples")
        check(run["fused_family"] == family, f"{section}/{tag}: family {run['fused_family']}")
        run.update({"phase": 5, "data_setup_seconds": setup, "N": n,
                    "D": sum(int(np.prod(v.shape[2:])) for v in res.samples.values())})
        emit(run)
        RESULTS.setdefault(section, {})[tag] = run


def phase_mxu():
    import torch
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    t0 = time.perf_counter()
    x, y, w_true = make_logreg_data(131072, 1024, seed=0)
    model = logistic_regression_model(x, y)
    setup = time.perf_counter() - t0
    comp = model.compiled("cuda")
    params = comp.initial_params
    probe = {
        "phase": 5, "run": "mxu/prior_probe",
        # the probe as it was: the whole log density, its likelihood dropped
        "whole_density_peak_gib": _probe_peak_gib(
            comp, lambda zf: comp.log_density_z_parts(params, comp.unravel_z(zf))[0]),
        # the probe as it is: the prior alone
        "prior_only_peak_gib": _probe_peak_gib(
            comp, lambda zf: comp.log_prior_z(params, comp.unravel_z(zf))),
    }
    emit(probe)
    RESULTS.setdefault("mxu", {})["prior_probe"] = probe
    _mxu_runs(model, "mxu", (("auto", "auto", "glm_bernoulli_f32"),
                             ("bf16", "bf16", "glm_bernoulli_bf16")),
              "bernoulli_logit", setup, 131072, 1024)
    del model, comp, params  # the compiled model holds its fused data and scratch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = _linreg_model(x, w_true)
    _mxu_runs(model, "mxu_linreg", (("auto", "auto", "glm_normal_f32"),
                                    ("bf16", "bf16", "glm_normal_bf16")),
              "normal_learned", time.perf_counter() - t0, 131072, 1024)


def phase_chees():
    import numpy as np
    import torch
    from brancher_torch.inference import ChEESHMC
    from brancher_torch.ops import logreg

    x, y, model = _floor_model()
    xd = torch.as_tensor(x, device="cuda")
    yd = torch.as_tensor(np.asarray(y, np.float32), device="cuda")
    base = dict(kernel=ChEESHMC(), num_warmup=500, num_samples=1000, num_chains=1024, key=3)
    for tag, kname, trans, kw in (
            ("fused", "glm_bernoulli_f32", "leapfrog_f32", {"fused_leapfrog": True}),
            ("loop", "glm_bernoulli_f32", None, {}),
            ("logreg", "logreg_f32", None,
             {"value_and_grad_fn": lambda w: logreg.logreg_value_and_grad(w, xd, yd, 1.0)})):
        res, info = _run_sample(model, f"chees/{tag}", kname, transition_kernel=trans, **base, **kw)
        mean, sd, ess, rhat = _post_stats(res, "w")
        info.update({
            "phase": 6, "num_samples": 1000, "min_ess": float(ess.min()),
            "ess_per_second": float(ess.min()) / info["sampler_seconds"],
            "max_rhat": float(rhat.max()),
        })
        emit(info)
        RESULTS.setdefault("chees", {})[tag] = info
        check(info["max_rhat"] < 1.01, f"chees/{tag}: max R-hat {info['max_rhat']}")
        check(bool(np.isfinite(mean).all()) and mean.shape == (32,), f"chees/{tag}: bad means")
        if "floor_auto_moments" in RESULTS:  # phase 3 ran
            _mcse_compare(6, f"chees/{tag} vs nuts/auto", RESULTS["floor_auto_moments"],
                          (mean, sd, ess), "chees")


def phase_hmc():
    import numpy as np
    from brancher_torch.inference import HMC
    from brancher_torch.models import conjugate_normal_model

    model, info = conjugate_normal_model()
    res, run = _run_sample(model, "hmc_conjugate/fused", "glm_normal_f32",
                           transition_kernel="leapfrog_f32", kernel=HMC(num_integration_steps=16),
                           fused_leapfrog=True, num_warmup=500, num_samples=1000,
                           num_chains=64, key=4)
    # HMC's num_steps stat is the JAX package's (L+1)//2, not the drawn counts
    run["leaves_per_draw_is"] = "jax_estimate"
    _check_conjugate(res, run, info, 7, "hmc_conjugate/fused")
    RESULTS["hmc_conjugate"] = {"fused": run}

    # a long trajectory on the floor model, where K5 does most of the work
    _, _, model = _floor_model()
    warmup, draws = 100, 200
    res, run = _run_sample(model, "hmc_floor/fused", "glm_bernoulli_f32",
                           transition_kernel="leapfrog_f32",
                           kernel=HMC(num_integration_steps=HMC_FLOOR_STEPS), fused_leapfrog=True,
                           num_warmup=warmup, num_samples=draws, num_chains=1024, key=5)
    mean, sd, ess, rhat = _post_stats(res, "w")
    run.update({
        "phase": 7, "num_samples": draws, "leaves_per_draw_is": "jax_estimate",
        "sampler_ms_per_transition": run["sampler_seconds"] * 1e3 / (warmup + draws),
        "k5_launches": run["launches"]["leapfrog_f32"], "min_ess": float(ess.min()),
        "ess_per_second": float(ess.min()) / run["sampler_seconds"],
        "max_rhat": float(rhat.max()),
    })
    emit(run)
    RESULTS["hmc_floor"] = {"fused": run}
    check(run["fused_family"] == "bernoulli_logit", f"hmc_floor: family {run['fused_family']}")
    check(run["max_rhat"] < 1.01, f"hmc_floor: max R-hat {run['max_rhat']}")
    check(bool(np.isfinite(mean).all()) and mean.shape == (32,), "hmc_floor: bad means")
    if "floor_auto_moments" in RESULTS:  # phase 3 ran
        _mcse_compare(7, "hmc_floor/fused vs nuts/auto", RESULTS["floor_auto_moments"],
                      (mean, sd, ess), "hmc_floor")


def _main_launches():
    totals = {name: 0 for name in _all_kernels()}
    for section in ("floor", "conjugate", "mxu", "mxu_linreg", "chees", "hmc_conjugate",
                    "hmc_floor"):
        for run in RESULTS.get(section, {}).values():
            for name, count in run.get("launches", {}).items():
                totals[name] += count
    return totals


def _summary_entry(name, k, rows, main, launches, err_keys):
    check(launches > 0, f"{name} was never launched on a sample() path")
    return {
        "name": name, "route": "cuda", "source": k.source,
        "replaces": k.replaces.split()[0], "launches": launches,
        "max_abs_err": max(r[e] for r in rows for e in err_keys),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "matmul_pair_ms": main.get("matmul_pair_ms"), "tflops": main["tflops"],
        "shape": [main["C"], main["N"], main["D"]], "n_steps": main.get("n_steps"),
        "ok": all(r["ok"] for r in rows),
    }


def summary_line():
    main_launches = _main_launches()
    out = []
    for name, k in _all_kernels().items():
        rows = RESULTS["kernels"][name]
        if name in MAIN_SHAPE:
            main = next(r for r in rows if r["shape"] == MAIN_SHAPE[name])
            out.append(_summary_entry(name, k, rows, main, main_launches[name],
                                      ("val_max_abs", "grad_max_abs")))
            continue
        if name in NORMAL_PATHS:  # K3/K4: one entry per path, its run's launches
            for (section, tag), shape in NORMAL_PATHS[name]:
                main = next(r for r in rows if r["shape"] == shape)
                out.append(_summary_entry(f"{name}/{section}", k, rows, main,
                                          RESULTS[section][tag]["launches"][name],
                                          ("val_max_abs", "grad_max_abs")))
            continue
        # K5: one entry per path, its launches from that path's run and its
        # row at that path's shape and family, at the path's step count (or
        # the one nearest the run's leapfrogs per draw)
        for (section, tag), shape, family, steps in LEAPFROG_PATHS:
            run = RESULTS[section][tag]
            check(run["fused_family"] == family, f"{section}/{tag}: family {run['fused_family']}")
            path_rows = [r for r in rows if r["shape"] == shape and r["family"] == family]
            want = run["leaves_per_draw"] if steps is None else steps
            main = min(path_rows, key=lambda r: abs(r["n_steps"] - want))
            out.append(_summary_entry(f"{name}/{section}", k, path_rows, main,
                                      run["launches"][name], ("max_abs",)))
    return {"kernels": out}


STEPS = {1: phase_environment, 2: phase_kernels, 3: phase_floor, 4: phase_conjugate,
         5: phase_mxu, 6: phase_chees, 7: phase_hmc}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="", help="comma-separated subset of 1-7 (default: all)")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import brancher_torch
    except ImportError:
        print("chip_smoke: brancher_torch is not beside this script", file=sys.stderr)
        return 2
    if Path(brancher_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: brancher_torch found outside this checkout", file=sys.stderr)
        return 2

    chosen = sorted(STEPS) if not args.phases else sorted({int(p) for p in args.phases.split(",")} | {1})
    t0 = time.perf_counter()
    for num in chosen:
        t = time.perf_counter()
        STEPS[num]()
        RESULTS.setdefault("phase_seconds", {})[num] = time.perf_counter() - t
    RESULTS["total_seconds"] = time.perf_counter() - t0
    emit({"phase": 8, "phase_seconds": RESULTS["phase_seconds"], "total_seconds": RESULTS["total_seconds"]})
    if chosen != sorted(STEPS):
        return 0  # a subset: no summary, no "ok" line
    emit(summary_line())
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
