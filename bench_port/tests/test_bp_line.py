"""The result line of a run, driven on the CPU at a tiny size, and the
command's refusal without a card."""
import json
import subprocess
import sys

import pytest

from bench_port import check, harness
from bench_port.tests.bp_tiny import tiny_run


def test_tiny_run_prints_one_result_line():
    out = tiny_run("covtype_logreg.nuts_c64")
    line = out["line"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(check.NUMBERS)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in harness.Cell(harness.load_benchmark(),
                                             "covtype_logreg.nuts_c64").metrics["end_to_end"]}
    assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    # the potential's numbers are deterministic: they pass at any size
    assert line["checks"]["grad_err"]["value"] <= line["checks"]["grad_err"]["limit"]
    assert line["checks"]["value_err"]["value"] <= line["checks"]["value_err"]["limit"]
    json.dumps(line)


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run([sys.executable, str(harness.ROOT / "bench_port" / "run.py"),
                          "--workload", "covtype_logreg.nuts_c64", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""


def test_data_probe_runs_other_data_sets():
    from bench_port import dataprobe
    from bench_port.tests.bp_tiny import tiny_cell

    cell = tiny_cell("covtype_logreg.nuts_c64")
    base = dict(cell.cfg)
    rows = list(dataprobe.probe(cell, [11, 12], 2**31 + 5, 1.0, "cpu"))
    assert [r["data_seed"] for r in rows] == [11, 12] and cell.cfg == base
    for r in rows:
        assert set(r["numbers"]) >= set(check.NUMBERS) and r["draws"] >= 1
        assert r["numbers"]["grad_err"] <= cell.wl["limits"]["grad_err"]
    assert rows[0]["numbers"]["value_err"] != rows[1]["numbers"]["value_err"]
