#!/usr/bin/env python3
"""The ARD run's ms a value+grad call, eager against graphed, and what two
processes sharing one card cost each other's host loop.

    python3 scripts/torch_ard_graphed.py ard       # eager, graphed, eager, graphed
    python3 scripts/torch_ard_graphed.py ard_one   # one eager ARD run
    python3 scripts/torch_ard_graphed.py floor     # one floor NUTS run (K1)

"ard": chip_smoke.py's phase-8 model and hand-fused potential (1024
chains, NUTS(max_depth=8), target_accept 0.95, key 6) at 30 warmup + 50
draws, with the potential called eagerly and replayed from a CUDA graph
(``GraphedValueAndGrad``), in turns.  Each line prints the sampler seconds,
the value+grad calls, ms a call and the mean of w's draws (equal when the
two runs draw the same numbers).  "floor" runs phase 3's floor (K1) at 100
+ 300.  Start "floor" and "ard_one" together, in two processes, to see
what each costs the other on one card:

    python3 scripts/torch_ard_graphed.py floor & python3 scripts/torch_ard_graphed.py ard_one

Prints one JSON line; the card's name and power limit come from
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ard(graphed, warm, draws):
    import chip_smoke as cs
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.inference.hmc import GraphedValueAndGrad

    model, fused = cs._ard_model_and_potential()
    fused = fused.fn if isinstance(fused, GraphedValueAndGrad) else fused
    vg = GraphedValueAndGrad(fused) if graphed else fused
    t0 = time.perf_counter()
    res = sample(model, kernel=NUTS(max_depth=8), num_warmup=warm, num_samples=draws,
                 num_chains=1024, key=6, target_accept=0.95, value_and_grad_fn=vg,
                 ess_vars=["w", "tau"], device="cuda")
    d = res.diagnostics
    return {"graphed": graphed, "wall": time.perf_counter() - t0, "sampler_s": d["sampler_seconds"],
            "calls": d["value_and_grad_calls"],
            "ms_per_call": d["sampler_seconds"] * 1e3 / d["value_and_grad_calls"],
            "w_mean": float(res.samples["w"].double().mean())}


def floor(warm, draws):
    import chip_smoke as cs
    from brancher_torch.inference import NUTS, sample

    _, _, model = cs._floor_model()
    res = sample(model, kernel=NUTS(max_depth=8), num_warmup=warm, num_samples=draws,
                 num_chains=1024, key=0, device="cuda")
    d = res.diagnostics
    return {"floor_sampler_s": d["sampler_seconds"], "calls": d["value_and_grad_calls"],
            "ms_per_call": d["sampler_seconds"] * 1e3 / d["value_and_grad_calls"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_ard_graphed: CUDA is not available", file=sys.stderr)
        return 2
    from brancher_torch.ops import cuda_build

    for source in ("glm_vg", "leapfrog"):
        cuda_build.load_library(source)
    mode = sys.argv[1] if len(sys.argv) > 1 else "ard"
    if mode == "ard":
        out = [ard(g, 30, 50) for g in (False, True, False, True)]
    elif mode == "ard_one":
        out = [ard(False, 30, 50)]
    else:
        out = [floor(100, 300)]
    print(json.dumps({"mode": mode, "out": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
