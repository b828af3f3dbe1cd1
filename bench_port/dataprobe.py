"""The check on other data sets and set-up keys, run on the card.

    python3 bench_port/dataprobe.py --workload <cell> --data-seeds 7001,7002 --seed <n> --seconds 30

The benchmark's runs fix the data set (the configuration's ``data_seed``)
and the set-up's keys, so that every seed does the same work.  This runs
the cell in one process on the data set of each data seed, with set-up keys
of that data seed too, and prints one JSON line a data seed: whether the
check passed, its numbers, and the work (``warmup_s``, draws a second,
value+grad calls a draw, the smallest ESS).  The benchmark's own runs do not
run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def probe(cell, data_seeds, seed: int, seconds: float, device: str = "cuda"):
    """One summary a data seed: the cell run on that data set, its set-up
    keys from the data seed, its window's keys from ``seed``."""
    from bench_port import harness

    base = dict(cell.cfg)
    for ds in data_seeds:
        cell.cfg = dict(base, data_seed=int(ds))
        out = harness.run_cell(cell, seed, seconds, False, device, setup_seed=int(ds))
        ctx = out["ctx"]
        grads = sum(c["vg_calls"] for c in ctx["calls"])
        yield {"workload": cell.name, "data_seed": int(ds), "seed": seed,
               "correct": out["line"]["correct"], "numbers": out["numbers"],
               "warmup_s": ctx["warmup_s"],
               "draws_per_s": ctx["chains"] * ctx["draws"] / ctx["window_s"],
               "grads_per_draw": grads / ctx["draws"], "min_ess": ctx["min_ess"],
               "draws": ctx["draws"], "card": out["line"]["card"]}
    cell.cfg = base


if __name__ == "__main__":
    import torch

    from bench_port import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--data-seeds", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("dataprobe: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    for row in probe(cell, args.data_seeds.split(","), args.seed, args.seconds):
        print(json.dumps(row), flush=True)
