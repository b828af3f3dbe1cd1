"""Run one cell of BENCHMARK.json once and print its result as one JSON line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 2, printing no result, without enough CUDA devices, and 3 if a module
of JAX or of the JAX package was loaded.  Compile caches live at fixed
paths under ``build/`` of the checkout.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_port"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(CACHE / _sub)
# one host thread for PyTorch's CPU operations: the engines' loops run on
# the main thread, and idle pool threads only add to the host's spread
os.environ["OMP_NUM_THREADS"] = "1"
# the checkout's root, not this directory, is where imports start
sys.path[0] = str(ROOT)

if __name__ == "__main__":
    from bench_port.harness import main

    sys.exit(main(sys.argv[1:], T_START))
