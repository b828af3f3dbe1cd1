#!/usr/bin/env python3
"""K1/K2 (the Bernoulli GLM kernels of brancher_torch) pass by pass, on one card.

    python3 scripts/torch_bernoulli_passes.py              # from the repo root
    python3 scripts/torch_bernoulli_passes.py --tree DIR   # K1/K2 of another checkout

For the floor (C=1024, N=1000, D=32), ragged (100, 1037, 33), MXU-width
(256, 8192, 1024) and MXU (256, 131072, 1024) shapes, prints one JSON line
per kernel: the errors against the plain version, for K2 the readings of
its gate (``ops/glm.py::bf16_residual_readings``: the bf16 residual ties,
the raw gradient error beside the allowance for those ties, and the
gradient against the plain formula on K2's own residual),
bit-reproducibility, and the median ms of the kernel and of the plain
version, timed by ``chip_smoke.time_ms``.  Then, at the floor and MXU
shapes, the host's time to enqueue one call and each pass's device time
from torch.profiler.

``--tree DIR`` takes brancher_torch from DIR instead (another commit's
tree, unpacked with ``git archive``) and times its K1/K2 with this
checkout's ``time_ms``, so that two designs are timed alike; it prints the
errors and times only.  Needs CUDA; imports no JAX.
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
          "mxu_width": (256, 8192, 1024), "mxu": (256, 131072, 1024)}


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def inputs(c, n, d, gen):
    x = torch.randn((n, d), generator=gen, device="cuda") / d**0.5
    y = (torch.rand((n,), generator=gen, device="cuda") < 0.5).float()
    b = 0.3 * torch.randn((n,), generator=gen, device="cuda")
    z = torch.randn((c, d), generator=gen, device="cuda")
    return x, y, b, z


def errors_and_times(G, tree):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, (c, n, d) in SHAPES.items():
        x, y, b, z = inputs(c, n, d, gen)
        m, iv = torch.linspace(-1, 1, d, device="cuda"), torch.linspace(0.5, 2.0, d, device="cuda")
        for dtype in ("f32", "bf16"):
            data = G.build_glm_data("bernoulli_logit", x, y, b, m, iv, ll_scale=1.3,
                                    dtype=dtype, device="cuda")
            k = G.kernel_for("bernoulli_logit", dtype)
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
        del x, y, b, z, data
        torch.cuda.empty_cache()


def passes(G):
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in ("floor", "mxu"):
        c, n, d = SHAPES[shape]
        x, y, b, z = inputs(c, n, d, gen)
        for dtype in ("f32", "bf16"):
            data = G.build_glm_data("bernoulli_logit", x, y, b, torch.zeros(d), torch.ones(d),
                                    dtype=dtype, device="cuda")
            k = G.kernel_for("bernoulli_logit", dtype)
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
            print(json.dumps({"shape": shape, "kernel": k.name, "host_enqueue_ms": host_ms}),
                  flush=True)
            for e in prof.key_averages():
                t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                if t and "bern::" in e.key:
                    print(json.dumps({"shape": shape, "kernel": k.name, "pass": e.key.split("(")[0],
                                      "ms_per_call": t / 5 / 1e3, "launches": e.count}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, help="root of another checkout whose K1/K2 to time")
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
    errors_and_times(G, str(args.tree or "."))
    if args.tree is None:
        passes(G)
    return 0


if __name__ == "__main__":
    sys.exit(main())
