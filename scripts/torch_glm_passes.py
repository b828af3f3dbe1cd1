#!/usr/bin/env python3
"""K1-K4 (the GLM value+grad kernels of brancher_torch) pass by pass, on one card.

    python3 scripts/torch_glm_passes.py                           # from the repo root
    python3 scripts/torch_glm_passes.py --family normal_learned   # K3/K4 only
    python3 scripts/torch_glm_passes.py --family normal_learned --shapes ar1 ar2
    python3 scripts/torch_glm_passes.py --tree DIR                # another checkout's
    python3 scripts/torch_glm_passes.py --k56 [--tree DIR]        # K5 and K6 instead

For the floor (C=1024, N=1000, D=32), ragged (100, 1037, 33), MXU-width
(256, 8192, 1024) and MXU (256, 131072, 1024) shapes, and for the Normal
kernels also the linear-Gaussian regression's (256, 131072, 1025) and the
AR(1) and AR(2) shapes of 512 chains (512, 1999, 2) and (512, 998, 3), prints
one JSON line per kernel: the errors against the plain version, for the
bf16 kernels (K2, K4) the readings of their gate
(``ops/glm.py::bf16_residual_readings``: the bf16 residual ties, the raw
gradient error beside the allowance for those ties, and the gradient
against the plain formula on the kernel's own residual),
bit-reproducibility, and the median ms of the kernel and of the plain
version, timed by ``chip_smoke.time_ms``.  Then, at the floor, MXU,
linear-Gaussian and AR shapes, ``plan_glm``'s plan, the host's time to
enqueue one call and each pass's device time from torch.profiler.
``--shapes`` restricts the run to the shapes named.

``--tree DIR`` takes brancher_torch from DIR instead (another commit's
tree, unpacked with ``git archive``) and times its kernels with this
checkout's ``time_ms``, so that two designs are timed alike; it prints the
errors and times only.  ``--family`` restricts the run to one family.

``--k56`` times K5 (the fused leapfrog) at the floor shape for 1, 8 and 32
steps in both families and at the conjugate shape for 8 (Normal), and K6
(logreg value+grad) at the floor and MXU shapes, on chip_smoke.py's phase-2
inputs, through the entry points both designs share
(``build_fused_leapfrog``, ``logreg_value_and_grad``): one JSON line each
with the error against the plain version, bit-reproducibility and the
median ms.  With ``--tree`` it times another checkout's K5 and K6 alike.
Needs CUDA; imports no JAX.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import time_ms  # noqa: E402  (chip_smoke imports brancher_torch lazily)

SHAPES = {"floor": (1024, 1000, 32), "ragged": (100, 1037, 33),
          "mxu_width": (256, 8192, 1024), "mxu": (256, 131072, 1024),
          "linreg": (256, 131072, 1025), "ar1": (512, 1999, 2), "ar2": (512, 998, 3)}
NORMAL_ONLY = ("linreg", "ar1", "ar2")
FAMILIES = ("bernoulli_logit", "normal_learned")


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def build(G, family, c, n, d, dtype, gen):
    """Inputs as chip_smoke.py's phase 2 draws them, and the data of one kernel."""
    x = torch.randn((n, d), generator=gen, device="cuda") / d**0.5
    if family == "bernoulli_logit":
        y = (torch.rand((n,), generator=gen, device="cuda") < 0.5).float()
    else:
        y = torch.randn((n,), generator=gen, device="cuda")
    b = 0.3 * torch.randn((n,), generator=gen, device="cuda")
    z = torch.randn((c, d), generator=gen, device="cuda")
    m, iv = torch.linspace(-1, 1, d, device="cuda"), torch.linspace(0.5, 2.0, d, device="cuda")
    u = None
    if family == "normal_learned":
        u = torch.zeros(d, device="cuda")
        u[-1] = 0.1
    data = G.build_glm_data(family, x, y, b, m, iv, u=u, c0=-0.3, ll_scale=1.3, dtype=dtype,
                            device="cuda")
    return data, z


def errors_and_times(G, tree, families, shapes):
    for shape in shapes:
        c, n, d = SHAPES[shape]
        for family in families:
            if family != "normal_learned" and shape in NORMAL_ONLY:
                continue
            for dtype in ("f32", "bf16"):
                gen = torch.Generator(device="cuda").manual_seed(0)  # the same inputs in every tree
                data, z = build(G, family, c, n, d, dtype, gen)
                k = G.kernel_for(family, dtype)
                v, g = k(z, data)
                v2, g2 = k(z, data)
                v_ref, g_ref = data.plain(z)
                row = {"tree": tree, "shape": shape, "C": c, "N": n, "D": d, "kernel": k.name,
                       "val_max_rel": rel(v, v_ref), "grad_max_rel": rel(g, g_ref),
                       "deterministic": bool(torch.equal(v, v2) and torch.equal(g, g2)),
                       "ms": time_ms(lambda: k(z, data)), "plain_ms": time_ms(lambda: data.plain(z))}
                if dtype == "bf16" and hasattr(k, "residual"):
                    row.update(G.bf16_residual_readings(g, k.residual(z, data), z, data, g_ref))
                print(json.dumps(row), flush=True)
                del data, z
                torch.cuda.empty_cache()


def k5_k6_times(tree):
    """K5 and K6 of the brancher_torch on sys.path, on chip_smoke.py's
    phase-2 inputs (the same in every tree), timed with one time_ms."""
    import brancher_torch.ops.leapfrog as LF
    import brancher_torch.ops.logreg as LR

    for family, shape, steps in (("bernoulli_logit", "floor", (1, 8, 32)),
                                 ("normal_learned", "floor", (1, 8, 32)),
                                 ("normal_learned", "conjugate", (8,))):
        c, n, d = {"floor": SHAPES["floor"], "conjugate": (64, 20, 1)}[shape]
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((n, d), generator=gen, device="cuda") / d**0.5
        y = ((torch.rand((n,), generator=gen, device="cuda") < 0.5).float()
             if family == "bernoulli_logit" else torch.randn((n,), generator=gen, device="cuda"))
        b = 0.3 * torch.randn((n,), generator=gen, device="cuda")
        z = torch.randn((c, d), generator=gen, device="cuda")
        m, iv = torch.linspace(-1, 1, d, device="cuda"), torch.linspace(0.5, 2.0, d, device="cuda")
        u = torch.zeros(d, device="cuda")
        u[-1] = 0.1
        lf = LF.build_fused_leapfrog(family, x, y, b, m, iv,
                                     u=u if family == "normal_learned" else None, c0=-0.3,
                                     ll_scale=1.3, device="cuda")
        r = torch.randn((c, d), generator=gen, device="cuda")
        _, g = lf.data.plain(z)
        im, eps = torch.linspace(0.5, 1.5, d, device="cuda"), torch.tensor(0.05, device="cuda")
        for n_steps in steps:
            st = torch.tensor(n_steps, dtype=torch.int32, device="cuda")
            out, again = lf(z, r, g, eps, im, st), lf(z, r, g, eps, im, st)
            ref = LF.reference_leapfrog(lf.data.plain)(z, r, g, eps, im, n_steps)
            print(json.dumps({
                "tree": tree, "kernel": "K5 " + LF.LEAPFROG.name, "family": family, "shape": shape,
                "C": c, "N": n, "D": d, "n_steps": n_steps,
                "max_rel": max(rel(a, bb) for a, bb in zip(out, ref)),
                "deterministic": all(torch.equal(a, bb) for a, bb in zip(out, again)),
                "ms": time_ms(lambda: lf(z, r, g, eps, im, st))}), flush=True)
    for shape in ("floor", "mxu"):
        c, n, d = SHAPES[shape]
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((n, d), generator=gen, device="cuda") / d**0.5
        y = (torch.rand((n,), generator=gen, device="cuda") < 0.5).float()
        w = torch.randn((c, d), generator=gen, device="cuda")
        (v, g), (v2, g2) = (LR.logreg_value_and_grad(w, x, y, 1.5) for _ in range(2))
        v_ref, g_ref = LR.logreg_value_and_grad_reference(w, x, y, 1.5)
        print(json.dumps({
            "tree": tree, "kernel": "K6 " + LR.LOGREG.name, "shape": shape, "C": c, "N": n, "D": d,
            "val_max_rel": rel(v, v_ref), "grad_max_rel": rel(g, g_ref),
            "deterministic": bool(torch.equal(v, v2) and torch.equal(g, g2)),
            "ms": time_ms(lambda: LR.logreg_value_and_grad(w, x, y, 1.5))}), flush=True)
        del x, y, w
        torch.cuda.empty_cache()


def passes(G, families, shapes):
    from torch.profiler import ProfilerActivity, profile

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in [s for s in shapes if s not in ("ragged", "mxu_width")]:
        c, n, d = SHAPES[shape]
        for family in families:
            if family != "normal_learned" and shape in NORMAL_ONLY:
                continue
            for dtype in ("f32", "bf16"):
                gen = torch.Generator(device="cuda").manual_seed(1)
                data, z = build(G, family, c, n, d, dtype, gen)
                k = G.kernel_for(family, dtype)
                for _ in range(3):
                    k(z, data)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):  # the host's time to enqueue one call
                    k(z, data)
                host_ms = (time.perf_counter() - t0) * 10
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        k(z, data)
                    torch.cuda.synchronize()
                print(json.dumps({"shape": shape, "kernel": k.name, "host_enqueue_ms": host_ms,
                                  "plan": G.plan_glm(c, n, d, dtype, sms)._asdict()}),
                      flush=True)
                for e in prof.key_averages():
                    t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                    if t and "glm90::" in e.key:
                        print(json.dumps({"shape": shape, "kernel": k.name,
                                          "pass": e.key.split("(")[0], "ms_per_call": t / 5 / 1e3,
                                          "launches": e.count}), flush=True)
                del data, z
                torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, help="root of another checkout whose kernels to time")
    parser.add_argument("--family", choices=FAMILIES, help="one family only (default: both)")
    parser.add_argument("--k56", action="store_true", help="time K5 and K6 instead of K1-K4")
    parser.add_argument("--shapes", nargs="+", choices=list(SHAPES), default=list(SHAPES),
                        help="these shapes only (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    tree = (args.tree or ROOT).resolve()
    sys.path.insert(0, str(tree))
    import brancher_torch.ops.glm as G

    if Path(G.__file__).resolve().parents[2] != tree:
        print(f"brancher_torch came from {G.__file__}, not {tree}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.k56:
        k5_k6_times(str(args.tree or "."))
        return 0
    families = (args.family,) if args.family else FAMILIES
    errors_and_times(G, str(args.tree or "."), families, args.shapes)
    if args.tree is None:
        passes(G, families, args.shapes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
