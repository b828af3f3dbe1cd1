#!/usr/bin/env python3
"""Drive brancher_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py            # every phase, one card

Phases (each prints one or more JSON lines tagged "phase"):
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build of brancher_torch/csrc/glm_vg.cu;
  2. kernels K1-K4 against their plain PyTorch versions at the floor shape
     (C=1024, N=1000, D=32), the conjugate shape (C=64, N=20, D=1) and the
     MXU-scale GLM shape (C=256, N=131072, D=1024): errors, the kernel's
     and the plain version's median ms, the bound's ms, and as context the
     ms of the two torch.matmul products alone;
  3. the main path at the floor config: make_logreg_data(1000, 32) ->
     logistic_regression_model -> sample(NUTS(max_depth=8), 500 warmup,
     1000 draws, 1024 chains) with fused_potential "auto" (K1), "bf16" (K2)
     and "off" (autodiff, the yardstick), fewer draws for the last two;
  4. the conjugate model with "auto" (K3) and "bf16" (K4) against its
     closed-form posterior;
  5. the MXU-scale logistic regression (N=131072, D=1024, 256 chains) with
     "auto" and "bf16";
  6. the {"kernels": [...]} summary, the card's name and power limit, and
     the last line {"ok": true, "device": {...}}.

Every launch counter is set to 0 just before each sample() run and read
just after it; a run whose kernel did not launch once per value+grad call
fails the script.  Any failed check raises: the script then exits
non-zero and prints no "ok" line.  Without CUDA, or without the
brancher_torch package beside it, it exits 2 at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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
}
# each kernel's shape on the main path (phase 3 for K1/K2, phase 4 for K3/K4)
MAIN_SHAPE = {"bernoulli_logit": "floor", "normal_learned": "conjugate"}
# Limit on max|kernel - plain| / max(max|plain|, 1), for val and grad.  The
# kernel and its plain version differ only in summation order: the worst
# reading on an H100 was 9.4e-7 (PERF.md).  For bf16 the product of two
# bf16 values is exact in f32, so the sums that feed the bf16 rounding of
# the residual agree as closely.  The limit sits above that reading and
# below the controls that each row also measures: the f32 plain version
# with TF32 products, and for bf16 the plain version without the bf16
# rounding of z and the residual.  A kernel that did either would fail.
TOL = 1e-5

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


def time_ms(fn, reps: int = 11, warmup: int = 2) -> float:
    """Median ms of ``reps`` launches enqueued back to back, each between
    two CUDA events (so host time between launches hides behind the card
    unless the host is the slower one)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


# ---------------------------------------------------------------------------
def phase_environment():
    import torch
    from brancher_torch.ops import cuda_build

    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    cuda_build.load_library("glm_vg")  # nvcc from the checkout's source
    build_s = time.perf_counter() - t0
    ptxas = (cuda_build.BUILD_DIR / "glm_vg.log").read_text()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    env = {
        "phase": 1, "nvidia_smi": smi, "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "peak_bytes_per_s": PEAK_BYTES, "peak_ops_per_s": PEAK_OPS,
        "build_seconds": round(build_s, 3),
        "ptxas": [ln.strip() for ln in ptxas.splitlines() if "registers" in ln],
    }
    RESULTS["environment"] = env
    emit(env)


def _rel(got, ref) -> float:
    """max|got - ref| over max(max|ref|, 1): the quantity TOL limits."""
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


def phase_kernels():
    import torch
    from brancher_torch.ops import glm

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {k: [] for k in glm.KERNELS}
    for shape_name, (c, n, d) in SHAPES.items():
        for family in ("bernoulli_logit", "normal_learned"):
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
                ok = (err["val_max_rel"] <= TOL and err["grad_max_rel"] <= TOL
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
                flops = glm.glm_flops(c, n, d)
                nbytes = glm.glm_bytes(c, n, d, 2 if dtype == "bf16" else 4, family)
                t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_OPS[dtype] * 1e3
                row = {
                    "phase": 2, "kernel": kernel.name, "shape": shape_name, "C": c, "N": n, "D": d,
                    **err, **control, "tolerance_rel": TOL, "ok": ok, "deterministic": deterministic,
                    "ms": ms, "plain_ms": plain_ms, "matmul_pair_ms": matmul_ms,
                    "flops": flops, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "tflops": flops / (ms * 1e-3) / 1e12,
                }
                emit(row)
                per_kernel[kernel.name].append(row)
                check(ok, f"{kernel.name} at {shape_name} disagrees with its plain version: {err}")
                check(deterministic, f"{kernel.name} at {shape_name} is not bit-reproducible")
            del x, y, b, z, data
            torch.cuda.empty_cache()
    for k in glm.KERNELS.values():
        k.launches = 0  # comparison launches do not count for the main path
    RESULTS["kernels"] = per_kernel


def _run_sample(model, tag, kernel_name, **kw):
    """One sample() run with every launch counter at 0 before it; checks
    that the expected kernel (or none) ran once per value+grad call."""
    import torch
    from brancher_torch.inference import sample
    from brancher_torch.ops import glm

    for k in glm.KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sample(model, device="cuda", **kw)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in glm.KERNELS.values()}
    d = res.diagnostics
    calls = d["value_and_grad_calls"]
    for name, count in launches.items():
        want = calls if name == kernel_name else 0
        check(count == want, f"{tag}: {name} launched {count} times, expected {want}")
    check(kernel_name is None or calls > 0, f"{tag}: no value+grad call")
    draws = res.stats["num_steps"].shape[1]
    leaves = int(res.stats["num_steps"][0].sum())
    info = {
        "run": tag, "kernel": kernel_name, "launches": launches.get(kernel_name, 0),
        "fused_family": d["fused_family"], "fused_dtype": d["fused_dtype"],
        "sampler_seconds": d["sampler_seconds"], "wall_seconds": wall,
        "value_and_grad_calls": calls, "warmup_leaf_iterations": d["warmup_leapfrog"],
        "sampling_leaf_iterations": leaves, "leaves_per_draw": leaves / draws,
        "host_syncs": d["host_syncs"],
        "host_syncs_per_draw": d["host_syncs"] / (draws + kw.get("num_warmup", 0)),
        "sampler_ms_per_vg_call": d["sampler_seconds"] * 1e3 / max(calls, 1),
        "divergences": d["num_divergences"], "mean_accept": d["mean_accept_prob"],
        "step_size": float(d["step_size"]),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    return res, info


def _post_stats(res, name):
    import numpy as np

    x = res.samples[name].double().cpu().numpy()
    ess = np.asarray(res.diagnostics["ess"][name], np.float64)
    mean = x.mean(axis=(0, 1))
    sd = x.std(axis=(0, 1))
    return mean, sd, ess, np.asarray(res.diagnostics["r_hat"][name], np.float64)


def phase_floor():
    import numpy as np
    from brancher_torch.inference import NUTS
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    x, y, _ = make_logreg_data(1000, 32, seed=0)
    model = logistic_regression_model(x, y)
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
    m0, s0, e0 = runs["off"]
    for tag in ("auto", "bf16"):
        m1, s1, e1 = runs[tag]
        mcse = np.sqrt(s0**2 / e0 + s1**2 / e1)
        z = np.abs(m1 - m0) / mcse
        line = {"phase": 3, "compare": f"{tag} vs off", "max_abs_diff": float(np.abs(m1 - m0).max()),
                "max_diff_in_mcse": float(z.max())}
        emit(line)
        RESULTS["floor"][f"{tag}_vs_off"] = line
        check(float(z.max()) < 5.0, f"floor: {tag} posterior mean differs from off by {z.max():.2f} MCSE")


def phase_conjugate():
    import numpy as np
    from brancher_torch.inference import NUTS
    from brancher_torch.models import conjugate_normal_model

    model, info = conjugate_normal_model()
    for tag, fp, kname in (("auto", "auto", "glm_normal_f32"), ("bf16", "bf16", "glm_normal_bf16")):
        res, run = _run_sample(model, f"conjugate/{tag}", kname, fused_potential=fp,
                               kernel=NUTS(max_depth=8), num_warmup=500, num_samples=1000,
                               num_chains=64, key=1)
        mean, sd, ess, rhat = _post_stats(res, "mu")
        mcse = float(sd / np.sqrt(ess))
        var_rel = float(sd**2 / info["post_var"] - 1.0)
        run.update({
            "phase": 4, "post_mean": float(mean), "closed_form_mean": float(info["post_mean"]),
            "mean_diff_in_mcse": abs(float(mean) - float(info["post_mean"])) / mcse,
            "post_var": float(sd**2), "closed_form_var": float(info["post_var"]),
            "var_rel_err": var_rel, "var_rel_tol": float(5 * np.sqrt(2.0 / ess)),
            "ess": float(ess), "max_rhat": float(rhat),
        })
        emit(run)
        RESULTS.setdefault("conjugate", {})[tag] = run
        check(run["fused_family"] == "normal_learned", f"conjugate/{tag}: family {run['fused_family']}")
        check(run["mean_diff_in_mcse"] < 5.0, f"conjugate/{tag}: mean off by {run['mean_diff_in_mcse']:.2f} MCSE")
        check(abs(var_rel) < run["var_rel_tol"], f"conjugate/{tag}: variance off by {var_rel:.4f}")


def phase_mxu():
    import numpy as np
    from brancher_torch.inference import NUTS
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    t0 = time.perf_counter()
    x, y, _ = make_logreg_data(131072, 1024, seed=0)
    model = logistic_regression_model(x, y)
    setup = time.perf_counter() - t0
    for tag, fp, kname in (("auto", "auto", "glm_bernoulli_f32"), ("bf16", "bf16", "glm_bernoulli_bf16")):
        res, run = _run_sample(model, f"mxu/{tag}", kname, fused_potential=fp,
                               kernel=NUTS(max_depth=5), num_warmup=10, num_samples=10,
                               num_chains=256, key=2)
        w = res.samples["w"]
        check(tuple(w.shape) == (256, 10, 1024), f"mxu/{tag}: samples shape {tuple(w.shape)}")
        check(bool(np.isfinite(w.float().cpu().numpy()).all()), f"mxu/{tag}: non-finite samples")
        check(run["fused_family"] == "bernoulli_logit", f"mxu/{tag}: family {run['fused_family']}")
        run.update({"phase": 5, "data_setup_seconds": setup, "N": 131072, "D": 1024})
        emit(run)
        RESULTS.setdefault("mxu", {})[tag] = run


def summary_line():
    from brancher_torch.ops import glm

    main_launches = {k: 0 for k in glm.KERNELS}
    for section in ("floor", "conjugate", "mxu"):
        for run in RESULTS.get(section, {}).values():
            if run.get("kernel") in main_launches:
                main_launches[run["kernel"]] += run["launches"]
    out = []
    for name, k in glm.KERNELS.items():
        rows = RESULTS["kernels"][name]
        main = next(r for r in rows if r["shape"] == MAIN_SHAPE[k.family])
        check(main_launches[name] > 0, f"{name} was never launched on the main path")
        out.append({
            "name": name, "route": "cuda", "source": "brancher_torch/csrc/glm_vg.cu",
            "replaces": k.replaces.split()[0], "launches": main_launches[name],
            "max_abs_err": max(max(r["val_max_abs"], r["grad_max_abs"]) for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": [main["C"], main["N"], main["D"]], "ok": all(r["ok"] for r in rows),
            "at_shapes": {r["shape"]: {f: r[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                         "matmul_pair_ms", "val_max_rel", "grad_max_rel",
                                                         "control_val_rel", "control_grad_rel")}
                          for r in rows},
        })
    return {"kernels": out}


def main() -> int:
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

    t0 = time.perf_counter()
    steps = [phase_environment, phase_kernels, phase_floor, phase_conjugate, phase_mxu]
    for num, fn in enumerate(steps, start=1):
        t = time.perf_counter()
        fn()
        RESULTS.setdefault("phase_seconds", {})[num] = time.perf_counter() - t
    RESULTS["total_seconds"] = time.perf_counter() - t0
    emit({"phase": 6, "phase_seconds": RESULTS["phase_seconds"], "total_seconds": RESULTS["total_seconds"]})
    emit(summary_line())
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
