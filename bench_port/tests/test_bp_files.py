"""BENCHMARK.json against the rules its format keeps, and every configuration,
cell and metric file found by name."""
import json
import re
import subprocess
import sys

import pytest

from bench_port import check, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
ROOT = harness.ROOT


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind in ("end_to_end", "per_layer"), e["name"]))
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e


def test_cells_and_configs():
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and w["name"] == f"{w['config']}.{w['traffic']}"
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/") and _line(c["source"]) and _line(c["why"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        cell = harness.Cell(BENCH, w["name"])
        e2e = {m["name"] for m in cell.metrics["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metrics["per_layer"]
        moved = {m["moves"] for m in cell.metrics["per_layer"]}
        assert moved <= e2e


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(name):
    cell = harness.Cell(BENCH, name)
    for key in ("config", "kernel", "kernel_args", "chains", "target_accept", "num_warmup",
                "draws_per_call", "fused_potential", "trace_draws", "check_calls",
                "stein_states", "limits"):
        assert key in cell.wl, key
    assert cell.wl["config"] == cell.entry["config"]
    assert set(cell.wl["limits"]) == set(check.NUMBERS)
    for fn in ("make_data", "build_model", "work"):
        assert callable(getattr(cell.model, fn))
    for fn in ("to_unconstrained", "prepare", "value_and_grad"):
        assert callable(getattr(cell.ref, fn))


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(name):
    reader = harness.load_module(harness.reader_path(name), f"t_{name}")
    assert callable(reader.read)


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_port import harness, check, frozen, precision, devtrace\n"
            "b = harness.load_benchmark()\n"
            "for c in b['configs']:\n"
            "    base = harness.ROOT / c['file']\n"
            "    harness.load_module(base.with_name(base.stem + '_ref.py'), 'r_' + c['name'])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"brancher_torch", "brancher_tpu", "jax", "jaxlib", "flax"}
