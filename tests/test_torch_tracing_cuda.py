"""The recorder's spans (``brancher_torch.metrics.tracing``) against the
card's own trace, on the card.

The spans are stamped with the host's ``perf_counter_ns`` and mapped onto
``torch.profiler``'s Unix-time clock by the pair of clocks read when the
recording starts (``Tracer.to_trace_clock``).  Here every kernel and copy
of a covtype-shaped ``sample()`` call, traced by the profiler on the card
alone, must fall inside that call's ``sample`` span, and the engine's
inside its ``sample.engine`` span, within 50 us.  These tests need a card:
they are marked ``cuda`` and skip without one.  The file imports neither
JAX nor brancher_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing_cuda.py -q
"""
import json

import numpy as np
import pytest
import torch

from brancher_torch import LogNormalVariable, NormalVariable, ProbabilisticModel, metrics
from brancher_torch.inference import NUTS, sample
from brancher_torch.models import logistic_regression_model, make_logreg_data

pytestmark = pytest.mark.cuda

SLACK_US = 50.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace of the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def covtype():
    x, y, _ = make_logreg_data(581_012, 55, seed=3)  # UCI Covertype's shape
    return logistic_regression_model(x, y)


def _card_trace(fn, path):
    """(fn's result, [(start, end, name)] us of the card's intervals,
    the trace's baseTimeNanoseconds) under the profiler of the card alone."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        out["res"] = fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
              for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]
    return out["res"], events, int(trace["baseTimeNanoseconds"])


def _mapped(tr, name, base):
    """Span ``name`` of the recorder's last call on the trace's clock, us."""
    call = max(s.call for s in tr.spans)
    s, = [s for s in tr.spans if s.name == name and s.call == call]
    return tr.to_trace_clock(s.start_ns, base), tr.to_trace_clock(s.end_ns, base)


def test_device_intervals_fall_inside_their_spans(cuda, covtype, tmp_path):
    kw = dict(kernel=NUTS(max_depth=8), num_chains=64, device="cuda", diagnostics_backend="none")
    first = sample(covtype, num_warmup=20, num_samples=1, key=1, **kw)
    assert first.diagnostics["fused_family"] == "bernoulli_logit"
    state = first.diagnostics["resume_state"]
    with metrics.tracing() as tr:
        res, events, base = _card_trace(
            lambda: sample(covtype, num_warmup=0, num_samples=5, resume_state=state, key=2, **kw),
            tmp_path / "trace.json")
    assert events and res.diagnostics["value_and_grad_calls"] > 0
    call_a, call_b = _mapped(tr, "sample", base)
    eng_a, eng_b = _mapped(tr, "sample.engine", base)
    for a, b, name in events:
        assert call_a - SLACK_US <= a <= b <= call_b + SLACK_US, (name, a - call_a, b - call_b)
        # the engine starts and ends at a device synchronise: what started
        # before either end has finished by it
        if a < eng_a - SLACK_US:
            assert b <= eng_a + SLACK_US, (name, b - eng_a)
        if a <= eng_b:
            assert b <= eng_b + SLACK_US, (name, b - eng_b)
    in_engine = [(a, b, n) for a, b, n in events if eng_a - SLACK_US <= a <= eng_b + SLACK_US]
    k1 = [(a, b) for a, b, n in events if "glm90" in n]
    assert k1 and len(in_engine) >= len(k1)
    for a, b in k1:
        assert eng_a - SLACK_US <= a <= b <= eng_b + SLACK_US
    print(f"first engine interval {min(a for a, _, _ in in_engine) - eng_a:.1f} us after the "
          f"span's start; last {eng_b - max(b for _, b, _ in in_engine):.1f} us before its end")


def test_tracing_leaves_the_card_draws_unchanged(cuda, covtype):
    kw = dict(kernel=NUTS(max_depth=8), num_chains=64, device="cuda", diagnostics_backend="none",
              num_warmup=10, num_samples=4, key=4)
    off = sample(covtype, **kw)
    with metrics.tracing() as tr:
        on = sample(covtype, **kw)
    for k in off.samples:
        assert torch.equal(off.samples[k], on.samples[k]), k
    assert off.diagnostics["step_size"] == on.diagnostics["step_size"]
    hist = tr.counters[1]["nuts.depth_hist"]
    assert sum(hist) == 64 * (10 + 4) and len(hist) == 9


def test_every_leaf_on_the_card_runs_in_the_kernel(cuda, covtype):
    """On the card every leaf's bookkeeping runs in kernel K7: replayed from
    the lockstep tree's graph (run eagerly in the tree's first transition)
    and in the pipelined loop.  ``nuts.kernel_leaves`` equals
    ``nuts.leaves`` in each call, and K7's launches count every leaf."""
    from brancher_torch.ops import NUTS_LEAF

    kw = dict(num_chains=64, device="cuda", diagnostics_backend="none", num_samples=5)
    before = NUTS_LEAF.launches
    with metrics.tracing() as tr:
        first = sample(covtype, kernel=NUTS(max_depth=8), num_warmup=20, key=1, **kw)
        state = first.diagnostics["resume_state"]
        sample(covtype, kernel=NUTS(max_depth=8), num_warmup=0, resume_state=state, key=2, **kw)
        sample(covtype, kernel=NUTS(max_depth=8, pipelined=True), num_warmup=0,
               resume_state=state, key=3, **kw)
    counters = [tr.counters[call] for call in (1, 2, 3)]
    for c in counters:
        assert c["nuts.kernel_leaves"] == c["nuts.leaves"] > 0
    assert counters[1]["nuts.graph_leaves"] == counters[1]["nuts.leaves"]
    assert NUTS_LEAF.launches - before == sum(c["nuts.leaves"] for c in counters)


def test_graph_capture_is_a_span(cuda):
    mu = NormalVariable(0.0, 2.0, "mu")
    sigma = LogNormalVariable(0.0, 0.5, "sigma")
    x = NormalVariable(mu, sigma, "x")
    x.observe(np.random.RandomState(0).normal(2.0, 1.0, size=30).astype(np.float32))
    model = ProbabilisticModel([x])
    with metrics.tracing() as tr:
        res = sample(model, kernel=NUTS(max_depth=6), num_chains=16, num_warmup=10,
                     num_samples=4, device="cuda", key=0, fused_potential="off")
    d = res.diagnostics
    assert d["value_and_grad_graphed"] and d["value_and_grad_captures"] >= 1
    captures = [s for s in tr.spans if s.name == "vg.capture"]
    assert len(captures) == d["value_and_grad_captures"]
    assert sum(s.seconds for s in captures) == pytest.approx(d["value_and_grad_capture_seconds"])
    engine, = [s for s in tr.spans if s.name == "sample.engine"]
    assert all(engine.start_ns <= s.start_ns <= s.end_ns <= engine.end_ns for s in captures)
