"""The span and counter recorder (``brancher_torch.metrics.tracing``) inside
``sample()`` and the lockstep vectorized NUTS engine, on the CPU.

Recording must change no draw, diagnostic or random stream; its spans must
nest as the work does; its counters must agree with the engine's own
(``warmup_leapfrog``, ``num_leapfrog``, ``chain_leapfrog``,
``host_syncs``); and the timers that ``sample()`` reports must be the
durations of their spans."""
import json

import numpy as np
import pytest
import torch

from brancher_torch import metrics
from brancher_torch.inference import HMC, NUTS, ChEESHMC, sample
from brancher_torch.inference.adaptation import build_warmup_schedule
from brancher_torch.inference.vectorized_nuts import (
    _count_tree, _NutsTree, _warmup_windows,
)
from brancher_torch.models import logistic_regression_model, make_logreg_data

torch.set_num_threads(2)

CHAINS, WARMUP, DRAWS = 4, 30, 12
TIMES = ("sampler_seconds", "sampling_seconds", "value_and_grad_capture_seconds")


@pytest.fixture(scope="module")
def model():
    x, y, _ = make_logreg_data(200, 5)
    return logistic_regression_model(x, y)


def _run(model, **kw):
    args = dict(kernel=NUTS(max_depth=6), num_samples=DRAWS, num_warmup=WARMUP,
                num_chains=CHAINS, device="cpu", key=7)
    args.update(kw)
    return sample(model, **args)


def _same(a, b, path="") -> None:
    """a and b hold the same numbers, bit for bit, at every leaf."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if k not in TIMES:
                _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _by_name(tr, name, call=None):
    return [s for s in tr.spans if s.name == name and (call is None or s.call == call)]


def _inside(span, outer) -> bool:
    return outer.start_ns <= span.start_ns <= span.end_ns <= outer.end_ns


KERNELS = {
    "nuts": dict(kernel=NUTS(max_depth=6)),
    "nuts_pipelined": dict(kernel=NUTS(max_depth=6, pipelined=True)),
    "nuts_dense": dict(kernel=NUTS(max_depth=6), mass="dense"),
    "hmc": dict(kernel=HMC(num_integration_steps=4)),
    "chees": dict(kernel=ChEESHMC(max_leapfrog=8)),
}


@pytest.mark.parametrize("engine", sorted(KERNELS))
def test_tracing_changes_no_number(model, engine):
    off = _run(model, **KERNELS[engine])
    with metrics.tracing() as tr:
        on = _run(model, **KERNELS[engine])
    _same(off.samples, on.samples, "samples")
    _same(off.stats, on.stats, "stats")
    _same(off.diagnostics, on.diagnostics, "diagnostics")
    resumed = [_run(model, **KERNELS[engine], num_warmup=0, key=8,
                    resume_state=r.diagnostics["resume_state"]) for r in (off, on)]
    _same(resumed[0].samples, resumed[1].samples, "resumed")
    assert len(_by_name(tr, "sample")) == 1 and len(_by_name(tr, "sample.engine")) == 1


def test_recorder_is_off_outside_its_block(model):
    assert metrics._tracer is None
    with metrics.tracing() as tr:
        with metrics.tracing() as inner:  # nested: the same recorder, still on after
            assert inner is tr
        assert metrics._tracer is tr
        _run(model, num_warmup=5, num_samples=2)
    assert metrics._tracer is None
    spans, counters = len(tr.spans), json.dumps(tr.counters)
    _run(model, num_warmup=5, num_samples=2)
    assert metrics._tracer is None
    assert len(tr.spans) == spans and json.dumps(tr.counters) == counters


def test_spans_nest_and_one_call_id_covers_one_call(model):
    with metrics.tracing() as tr:
        first = _run(model)
        _run(model, num_warmup=0, num_samples=4, resume_state=first.diagnostics["resume_state"])
    calls = _by_name(tr, "sample")
    assert [s.call for s in calls] == [1, 2] and all(s.parent is None for s in calls)
    assert calls[0].end_ns <= calls[1].start_ns
    for s in tr.spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns, s.name
        if s.parent is not None:
            parent = tr.spans[s.parent]
            assert parent.call == s.call and _inside(s, parent), (s.name, parent.name)
        assert _inside(s, calls[s.call - 1]), s.name
    chains = {"sample.prepare": ["sample"], "sample.recognize": ["sample.prepare"],
              "sample.engine": ["sample"],
              "sample.constrain": ["sample"], "sample.diagnostics": ["sample"],
              "nuts.warmup": ["sample.engine"], "nuts.window": ["nuts.warmup"],
              "nuts.draws": ["sample.engine"], "nuts.leaf": ["nuts.window", "nuts.draws"],
              "nuts.sync": ["nuts.leaf", "nuts.window", "nuts.draws"]}
    for s in tr.spans:
        if s.name in chains:
            assert tr.spans[s.parent].name in chains[s.name], s.name
    assert len(_by_name(tr, "sample.recognize")) == 2  # a GLM: the recognizer is asked
    stages = [s for s in tr.spans if tr.spans[s.parent or 0].name == "sample" and s.parent is not None
              and s.call == 1]
    assert [s.name for s in stages] == ["sample.prepare", "sample.engine", "sample.constrain",
                                        "sample.diagnostics"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))
    assert stages[0].end_ns == stages[1].start_ns  # the engine starts where prepare ends


def test_leaf_and_sync_spans_match_the_engine_counts(model):
    with metrics.tracing() as tr:
        res = _run(model)
    d = res.diagnostics
    leaves = d["warmup_leapfrog"] + int(res.stats["num_steps"][0].sum())
    assert len(_by_name(tr, "nuts.leaf")) == leaves == tr.counters[1]["nuts.leaves"]
    syncs = _by_name(tr, "nuts.sync")
    assert len(syncs) == d["host_syncs"]
    # every leaf has exactly one sync child, which starts with it
    per_leaf = {}
    for s in syncs:
        parent = tr.spans[s.parent]
        if parent.name == "nuts.leaf":
            assert s.start_ns == parent.start_ns
            per_leaf[s.parent] = per_leaf.get(s.parent, 0) + 1
    assert len(per_leaf) == leaves and set(per_leaf.values()) == {1}
    warmup, = _by_name(tr, "nuts.warmup")
    windows = _by_name(tr, "nuts.window")
    assert warmup.args == {"iterations": WARMUP, "leaves": d["warmup_leapfrog"]}
    assert sum(w.args["leaves"] for w in windows) == d["warmup_leapfrog"]
    assert [w.args["iterations"] for w in windows] == [b - a for a, b in _warmup_windows(
        *build_warmup_schedule(WARMUP))]
    for w in windows:
        assert len([s for s in _by_name(tr, "nuts.leaf") if s.parent == tr.spans.index(w)]) \
            == w.args["leaves"]
    draws, = _by_name(tr, "nuts.draws")
    assert draws.args == {"leaves": int(res.stats["num_steps"][0].sum())}


def test_live_leaves_and_depths_match_the_chains_trees(model):
    with metrics.tracing() as tr:
        first = _run(model)
        resumed = _run(model, num_warmup=0, resume_state=first.diagnostics["resume_state"])
    hist = tr.counters[1]["nuts.depth_hist"]
    assert len(hist) == 6 + 1 and sum(hist) == CHAINS * (WARMUP + DRAWS)
    assert sum(tr.counters[2]["nuts.depth_hist"]) == CHAINS * DRAWS
    live = tr.counters[2]["nuts.live_leaves"]
    assert live == round(CHAINS * float(resumed.diagnostics["chain_leapfrog"].sum()))
    assert live <= CHAINS * tr.counters[2]["nuts.leaves"]


def test_pipelined_leaves_and_syncs_match_the_engine_counts(model):
    """The pipelined sampling phase: one ``nuts.leaf`` a loop iteration,
    each with one ``nuts.sync`` child, a last sync alone; its leaves and
    live leaves in the call's counters."""
    pipelined = KERNELS["nuts_pipelined"]
    with metrics.tracing() as tr:
        first = _run(model, **pipelined)
        resumed = _run(model, **pipelined, num_warmup=0, resume_state=first.diagnostics["resume_state"])
    draws = _by_name(tr, "nuts.draws", call=2)[0]
    leaves = [s for s in _by_name(tr, "nuts.leaf", call=2) if tr.spans[s.parent] is draws]
    syncs = _by_name(tr, "nuts.sync", call=2)
    assert len(leaves) == draws.args["leaves"] == tr.counters[2]["nuts.leaves"] > 0
    assert len(syncs) == resumed.diagnostics["host_syncs"] == len(leaves) + 1
    assert sorted(tr.spans[s.parent].name for s in syncs) == ["nuts.draws"] + ["nuts.leaf"] * len(leaves)
    assert all(_inside(s, draws) for s in leaves)
    live = tr.counters[2]["nuts.live_leaves"]
    assert live == round(CHAINS * float(resumed.diagnostics["chain_leapfrog"].sum()))
    assert 0 < live <= CHAINS * len(leaves)
    assert "nuts.tree_state_bytes" not in tr.counters[2]  # no lockstep tree in the draws
    warmup = first.diagnostics["warmup_leapfrog"]
    assert tr.counters[1]["nuts.leaves"] == warmup + _by_name(tr, "nuts.draws", call=1)[0].args["leaves"]


@pytest.mark.parametrize("c,d,max_depth", [(4, 5, 6), (3, 7, 8)])
def test_tree_state_bytes_count_the_lockstep_trees_buffers(c, d, max_depth):
    """37 [C, d] float tensors (z, grad, the ends' and the moving end's
    points, the proposals, the momentum sums and the two checkpoint stacks
    of max_depth + 2 rows), nine [C] floats, three [C] flags, eps, the mass,
    n and the per-leaf schedule tables."""
    kdim, rows = max_depth + 1, 2**max_depth + 1
    tree = _NutsTree(c, d, torch.float32, "cpu", max_depth, 1000.0)
    per_chain = 2 + 6 + 3 + 2 + 2 + 2 + 2 * (kdim + 1)
    assert per_chain == 37 + 2 * (max_depth - 8)
    assert tree.state_bytes == (4 * per_chain * c * d + 4 * 9 * c + 3 * c + 4 + 4 * d + 8
                                + rows * (2 + kdim) + 8 * rows)


def test_tree_state_bytes_are_added_once_a_transition(model):
    with metrics.tracing() as tr:
        res = _run(model)
    d = res.diagnostics["inv_mass"].shape[-1]
    one = _NutsTree(CHAINS, d, torch.float32, "cpu", 6, 1000.0).state_bytes
    assert tr.counters[1]["nuts.tree_state_bytes"] == (WARMUP + DRAWS) * one
    assert sum(tr.counters[1]["nuts.depth_hist"]) == CHAINS * (WARMUP + DRAWS)


def test_depth_of_a_chain_is_the_doublings_its_live_leaves_fill():
    with metrics.tracing() as tr:
        _count_tree(tr, 255, torch.tensor([0., 1., 2., 3., 4., 7., 8., 255.]), kdim=9)
        _count_tree(tr, 3, torch.tensor([3., 1.]), kdim=9)
    c = tr.counters[0]
    assert c["nuts.leaves"] == 258 and c["nuts.live_leaves"] == 284
    # depths 0, 1, 2, 2, 3, 3, 4, 8, then 2, 1
    assert c["nuts.depth_hist"] == [1, 2, 3, 2, 1, 0, 0, 0, 1]


@pytest.mark.parametrize("num_warmup", [0, 1, 7, 30, 149, 150, 200, 300, 1000])
def test_warmup_windows_follow_the_schedule(num_warmup):
    in_slow, window_end = build_warmup_schedule(num_warmup)
    windows = _warmup_windows(in_slow, window_end)
    assert [i for w in windows for i in range(*w)] == list(range(num_warmup))
    for start, stop in windows:
        assert len(set(in_slow[start:stop])) == 1  # one phase a window
        assert not window_end[start:stop - 1].any()  # a slow window ends at its end
    slow = [w for w in windows if in_slow[w[0]]]
    assert len(slow) == int(window_end.sum())


def test_timers_are_the_durations_of_their_spans(model):
    with metrics.tracing() as tr:
        res = _run(model)
    engine, = _by_name(tr, "sample.engine")
    draws, = _by_name(tr, "nuts.draws")
    assert res.diagnostics["sampler_seconds"] == engine.seconds
    assert res.diagnostics["sampling_seconds"] == draws.seconds
    assert _inside(draws, engine)


def test_an_error_inside_a_traced_call_closes_its_spans(model):
    with metrics.tracing() as tr:
        with pytest.raises(ValueError):
            _run(model, mass="other")
        _run(model, num_warmup=2, num_samples=2)
    assert [s.call for s in _by_name(tr, "sample")] == [1, 2]
    assert all(s.end_ns is not None for s in tr.spans)
    assert tr.spans[_by_name(tr, "sample.engine")[0].parent].call == 2


def test_trace_clock_maps_by_the_pair_of_clocks():
    tr = metrics.Tracer()
    tr.clock = (5_000_000, 1_700_000_000_000_000_000)
    assert tr.to_trace_clock(5_000_000) == pytest.approx(1.7e15)
    base = 1_699_999_999_000_000_000
    assert tr.to_trace_clock(5_000_000, base) == pytest.approx(1e6)  # 1 s after the base, in us
    assert tr.to_trace_clock(7_500_000, base) == pytest.approx(1e6 + 2500.0)
    tr.spans.append(metrics.Span("x", 6_000_000, 6_250_000, None, 3, {"leaves": 2}))
    ev, = tr.chrome_events(base)
    assert ev["ts"] == pytest.approx(1e6 + 1000.0) and ev["dur"] == pytest.approx(250.0)
    assert ev["args"] == {"leaves": 2, "call": 3}


def test_spans_go_onto_a_chrome_trace_and_into_json(model, tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": 1_000, "traceEvents": [{"ph": "X"}]}))
    with metrics.tracing() as tr:
        _run(model, num_warmup=3, num_samples=2)
    tr.add_to_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert len(events) == 1 + len(tr.spans)
    assert {e["name"] for e in events[1:]} >= {"sample", "nuts.leaf", "nuts.sync"}
    rec = json.loads(json.dumps(tr.to_json()))
    assert len(rec["spans"]) == len(tr.spans) and rec["clock"] == list(tr.clock)
    assert rec["counters"]["1"]["nuts.leaves"] == len(_by_name(tr, "nuts.leaf"))
