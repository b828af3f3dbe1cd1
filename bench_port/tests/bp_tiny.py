"""Tiny CPU runs of a cell for the tests: the cell's files at sizes a test
run holds (fewer rows, chains, warmup and draws)."""
from bench_port import harness

TINY = {"chains": 8, "num_warmup": 60, "draws_per_call": 10, "check_calls": 3,
        "stein_states": 2048}


def tiny_cell(name: str, rows: int = 2000) -> harness.Cell:
    cell = harness.Cell(harness.load_benchmark(), name)
    cell.cfg = dict(cell.cfg, num_rows=min(cell.cfg["num_rows"], rows))
    cell.wl = dict(cell.wl, **TINY)
    return cell


def tiny_run(name: str, seed: int = 2**31 + 77, after_setup=None, seconds: float = 1.0):
    return harness.run_cell(tiny_cell(name), seed, seconds, False, "cpu", after_setup=after_setup)
