"""The program's spans read for the benchmark (``bench_port/spans.py`` and
its readers): idle gaps named by the innermost span on synthetic intervals,
a call's summary from a CPU run, and readers that return None where the
program has no recorder."""
import pytest
import torch

from bench_port import harness, spans
from brancher_torch import metrics

READERS = ("leaf_host_ms", "leaf_wait_ms", "live_leaf_share", "warmup_grads_per_iter")


def _reader(name):
    return harness.load_module(harness.reader_path(name), f"s_{name.replace('.', '_')}").read


def _ev(cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur}


def _synthetic_tracer():
    """One call on the trace clock (base 0, clock pair (0, 0): ns = us *
    1000): sample [0, 1000] us > engine [100, 900] > leaf [200, 500] > sync
    [200, 300], and a tree-ending sync [600, 650] in the engine."""
    tr = metrics.Tracer()
    tr.clock = (0, 0)
    tr.call = 1
    us = 1000
    top = tr.open("sample", 0)
    engine = tr.open("sample.engine", 100 * us)
    tr.span("nuts.sync", 200 * us, 300 * us, parent=tr.span("nuts.leaf", 200 * us, 500 * us))
    tr.span("nuts.sync", 600 * us, 650 * us)
    tr.close(engine, 900 * us)
    tr.close(top, 1000 * us)
    return tr


def test_innermost_span_around_points():
    nested = [(0.0, 10.0, 0, "a"), (1.0, 4.0, 1, "b"), (1.0, 2.0, 2, "c"), (6.0, 8.0, 1, "d")]
    assert spans.innermost(nested, [-1.0, 0.5, 1.5, 3.0, 5.0, 7.0, 9.0, 11.0]) == [
        spans.NO_SPAN, "a", "c", "b", "a", "d", "a", spans.NO_SPAN]


def test_idle_gaps_named_by_span_on_the_trace_clock():
    tr = _synthetic_tracer()
    events = [_ev("kernel", 150.0, 100.0),  # busy 150-250: gap 250-280 in the sync
              _ev("kernel", 280.0, 20.0),  # gap 300-420 in the leaf, after its sync
              _ev("gpu_memcpy", 420.0, 180.0),  # gap 600-640 in the tree-ending sync
              _ev("kernel", 640.0, 300.0),  # gap 940-980 in sample, outside the engine
              _ev("kernel", 980.0, 40.0),  # gap 1020-1100: outside every span
              _ev("kernel", 1100.0, 5.0), _ev("cpu_op", 0.0, 2000.0)]
    gaps = dict(spans.idle_gaps_by_span(events, tr, 1, 0))
    assert gaps == {"nuts.leaf": pytest.approx(120e-6), "nuts.sync": pytest.approx(70e-6),
                    "sample": pytest.approx(40e-6), spans.NO_SPAN: pytest.approx(80e-6)}
    # the base moves the spans, not the events: 0.5 ms later, the same gaps fall elsewhere
    assert dict(spans.idle_gaps_by_span(events, tr, 1, -500_000)) != gaps
    assert spans.idle_gaps_by_span(events, tr, 2, 0) == [[spans.NO_SPAN, pytest.approx(310e-6)]]


def test_summary_and_readers_on_a_synthetic_call():
    tr = _synthetic_tracer()
    tr.count("nuts.leaves", 1)
    tr.count("nuts.live_leaves", torch.tensor(3))
    s = spans.call_summary(tr, 1)
    assert s["leaves"] == 1 and s["syncs"] == 2
    assert s["leaf_s"] == pytest.approx(300e-6) and s["leaf_wait_s"] == pytest.approx(100e-6)
    assert s["wait_s"] == pytest.approx(150e-6) and s["live_leaves"] == 3
    assert s["stages"] == {"sample": pytest.approx(1e-3), "sample.engine": pytest.approx(800e-6)}
    ctx = {"chains": 4, "spans": {"draws": s, "warmup": dict(s, warmup={"iterations": 10,
                                                                         "leaves": 35})}}
    want = {"leaf_host_ms": 0.2, "leaf_wait_ms": 0.15, "live_leaf_share": 75.0,
            "warmup_grads_per_iter": 3.5}
    for name, value in want.items():
        assert _reader(name)(ctx) == pytest.approx(value), name
        assert _reader(name + ".host")(ctx) == pytest.approx(value), name


@pytest.mark.parametrize("ctx", [{"chains": 4}, {"chains": 4, "spans": None},
                                 {"chains": 4, "spans": {"draws": None, "warmup": None}}])
def test_readers_find_nothing_without_spans(ctx):
    for name in READERS:
        assert _reader(name)(ctx) is None, name


def test_a_cpu_call_summary_agrees_with_its_diagnostics():
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    x, y, _ = make_logreg_data(100, 4)
    model = logistic_regression_model(x, y)
    with spans.recording() as tr:
        res = sample(model, kernel=NUTS(max_depth=5), num_samples=6, num_warmup=20,
                     num_chains=3, device="cpu", key=5)
    d = res.diagnostics
    s = spans.call_summary(tr, spans.last_call(tr))
    assert s["leaves"] == s["counted_leaves"] == d["warmup_leapfrog"] + int(
        res.stats["num_steps"][0].sum())
    assert s["syncs"] == d["host_syncs"] and sum(s["depth_hist"]) == 3 * 26
    assert s["warmup"] == {"iterations": 20, "leaves": d["warmup_leapfrog"]}
    assert sum(w[1] for w in s["windows"]) == d["warmup_leapfrog"]
    assert s["stages"]["sample.engine"] == d["sampler_seconds"]
    assert 0.0 < s["leaf_wait_s"] <= s["wait_s"] and s["leaf_wait_s"] < s["leaf_s"]
    assert 0.0 < _reader("live_leaf_share")({"chains": 3, "spans": {"draws": s}}) <= 100.0


def test_without_the_recorder_nothing_is_read(monkeypatch):
    monkeypatch.delattr(metrics, "tracing")
    with spans.recording() as tr:
        assert tr is None
    assert spans.recorded_call(lambda: pytest.fail("the call runs only with the recorder")) is None


def test_span_probe_runs_a_tiny_cell(monkeypatch):
    """``spanprobe.probe`` end to end at a tiny size, with the CPU standing
    in for the card (its profiler on the host, synchronise a no-op)."""
    import torch.profiler

    from bench_port import spanprobe
    from bench_port.tests.bp_tiny import tiny_cell

    profile = torch.profiler.profile
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.profiler, "profile", lambda activities, **k: profile(
        activities=[torch.profiler.ProfilerActivity.CPU], **k))
    out = spanprobe.probe(tiny_cell("covtype_logreg.nuts_c64"), 2**31 + 9, 0.2, 1, device="cpu")
    assert set(out["metrics"]) == set(out["metrics_unprofiled"]) == {
        f"{n}.host" for n in READERS}
    assert out["metrics"]["live_leaf_share.host"]["value"] <= 100.0
    assert out["warmup"]["warmup"]["iterations"] == 60 and out["draws"]["leaves"] > 0
    assert len(out["ms_per_grad"]["turns_off_on"]) == 1 and out["added_s"] > 0.0
