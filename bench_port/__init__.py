"""The benchmark of brancher_torch (the PyTorch/CUDA port) on one H100.

``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Each configuration (``configs/<name>.json`` and ``.py``, with its plain
reference ``configs/<name>_ref.py``), each cell (``workloads/<cell>.json``) and
each metric (``metrics/<metric>.py``) is a file of its own, found by name.
"""
