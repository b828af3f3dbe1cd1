"""The control of a cell's check, run on the card at the cell's own size.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 --seconds 5

For each seed, in one process: the cell's set-up and a short window at its
own load, then the check's numbers of the program and, at the same states
and against the same float64 reference, of the reference computed in TF32
and in bf16 put in the program's place (and of the program's own bf16 path,
K2, where the run's potential is a GLM family).  One JSON line a seed.  The
benchmark's own runs do not run this; it gives the limits' upper readings.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

if __name__ == "__main__":
    import torch

    from bench_port import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda", controls=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "program": out["numbers"],
                          "controls": out["controls"], "correct": out["line"]["correct"],
                          "stages": out["ctx"]["stages"], "card": out["line"]["card"]}), flush=True)
