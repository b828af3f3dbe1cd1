#!/usr/bin/env python3
"""What a one-rank NCCL group costs the floor NUTS run, on one card.

    python3 scripts/torch_sharded_overhead.py [--draws 1000] [--reps 2]

The floor config of chip_smoke.py's phase 3 (make_logreg_data(1000, 32),
NUTS(max_depth=8), 1024 chains, 500 warmup, K1), run in one process in
these settings, each ``--reps`` times in turns:

  * "plain": no process group;
  * "group": a one-rank NCCL group open (parallel.initialize_distributed on
    a FileStore in a temporary directory), no mesh;
  * "mesh": the same group, ``mesh=chain_mesh()``;
  * "after": the group destroyed, no mesh.

Each line prints the sampler seconds, the warmup's and the draws' seconds
and leaves, ms a leaf, and K1's launches; then the host time of one
one-rank all-reduce of a float with the group open.  The card's name and
power limit come first.  Exits 2 without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def run(model, mesh, draws):
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.ops import kernel_wrappers

    k1 = kernel_wrappers()["glm_bernoulli_f32"]
    k1.launches = 0
    kw = {} if mesh is None else {"mesh": mesh}
    res = sample(model, kernel=NUTS(max_depth=8), num_warmup=500, num_samples=draws,
                 num_chains=1024, key=0, device="cuda", diagnostics_backend="none", **kw)
    d = res.diagnostics
    warm_s = d["sampler_seconds"] - d["sampling_seconds"]
    draw_leaves = int(res.stats["num_steps"][0].sum())
    return {"sampler_seconds": d["sampler_seconds"], "warmup_seconds": warm_s,
            "warmup_leaves": float(d["warmup_leapfrog"]), "draw_seconds": d["sampling_seconds"],
            "draw_leaves": draw_leaves,
            "warmup_ms_a_leaf": warm_s * 1e3 / float(d["warmup_leapfrog"]),
            "draw_ms_a_leaf": d["sampling_seconds"] * 1e3 / draw_leaves,
            "k1_launches": k1.launches, "value_and_grad_calls": d["value_and_grad_calls"]}


def all_reduce_us(n=2000):
    import torch
    import torch.distributed as dist

    x = torch.ones(1, device="cuda")
    for _ in range(50):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        dist.all_reduce(x)
    host = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return host * 1e6, (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--draws", type=int, default=1000)
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sharded_overhead: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch.distributed as dist
    from brancher_torch.models import logistic_regression_model, make_logreg_data
    from brancher_torch.parallel import chain_mesh, initialize_distributed

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    x, y, _ = make_logreg_data(1000, 32, seed=0)
    model = logistic_regression_model(x, y)
    run(model, None, 20)  # builds K1 and warms the process
    for rep in range(args.reps):
        print(json.dumps({"setting": "plain", "rep": rep, **run(model, None, args.draws)}), flush=True)
    with tempfile.TemporaryDirectory(prefix="sharded_overhead_") as tmp:
        initialize_distributed(coordinator_address=f"file://{tmp}/store", num_processes=1,
                               process_id=0, device="cuda", timeout_seconds=300)
        try:
            mesh = chain_mesh()
            for rep in range(args.reps):
                for setting, m in (("group", None), ("mesh", mesh)) if rep % 2 == 0 else (
                        ("mesh", mesh), ("group", None)):
                    print(json.dumps({"setting": setting, "rep": rep, **run(model, m, args.draws)}),
                          flush=True)
            host_us, total_us = all_reduce_us()
            print(json.dumps({"all_reduce_host_us": host_us, "all_reduce_us_to_sync": total_us}),
                  flush=True)
        finally:
            dist.destroy_process_group()
    for rep in range(args.reps):
        print(json.dumps({"setting": "after", "rep": rep, **run(model, None, args.draws)}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
