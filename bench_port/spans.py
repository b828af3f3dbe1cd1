"""The program's own spans and counters (``brancher_torch.metrics.tracing``)
read for the benchmark: a call's summary (the leaf's host time and its wait
at the sync, the chains' live share of the lockstep leaves, the warmup's
leaves window by window, the seconds of ``sample()``'s stages) and the
card's idle gaps named by the innermost program span around each, on the
profiler's clock.

``recording()`` turns the recorder on where the program has one and yields
None where it has not (a checkout older than the recorder), so every
summary is then None and the readers that read it return None.  Apart from
``recording`` and ``record``, pure functions of spans and trace events, so
the tests drive them with synthetic ones."""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

from bench_port import devtrace

NO_SPAN = "(no span)"
STAGES = ("sample", "sample.prepare", "sample.recognize", "sample.engine", "sample.constrain",
          "sample.diagnostics", "vg.capture", "nuts.warmup", "nuts.draws")


@contextlib.contextmanager
def recording():
    """The program's recorder for the block, or None where it has none."""
    try:
        from brancher_torch.metrics import tracing
    except ImportError:
        tracing = None
    if tracing is None:
        yield None
        return
    with tracing() as tr:
        yield tr


def record(fn, cpu: bool):
    """``devtrace.record``'s (events, wall seconds), with the trace's
    ``baseTimeNanoseconds`` third: its events' ``ts`` are microseconds
    after it, on the Unix clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_port_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    return events, wall_s, int(trace.get("baseTimeNanoseconds", 0))


def _seconds(s) -> float:
    return (s.end_ns - s.start_ns) * 1e-9


def call_summary(tr, call: int) -> dict:
    """What the readers read of call ``call`` of recorder ``tr``: the
    leaves and their seconds (``leaf_s`` the ``nuts.leaf`` spans, ``wait_s``
    every ``nuts.sync``, ``leaf_wait_s`` the syncs inside leaves), the
    counters, the warmup's leaves and iterations, each warmup window's
    [iterations, leaves, seconds], and the seconds of each stage
    (``STAGES``; ``vg.capture`` summed)."""
    spans = [s for s in tr.spans if s.call == call and s.end_ns is not None]
    leaf_ids = {i for i, s in enumerate(tr.spans) if s.call == call and s.name == "nuts.leaf"}
    leaves = [tr.spans[i] for i in sorted(leaf_ids)]
    syncs = [s for s in spans if s.name == "nuts.sync"]
    stages = defaultdict(float)
    for s in spans:
        if s.name in STAGES:
            stages[s.name] += _seconds(s)
    warmup = next((s.args for s in spans if s.name == "nuts.warmup"), None)
    counters = tr.counters.get(call, {})
    return {"leaves": len(leaves), "leaf_s": sum(_seconds(s) for s in leaves),
            "wait_s": sum(_seconds(s) for s in syncs),
            "leaf_wait_s": sum(_seconds(s) for s in syncs if s.parent in leaf_ids),
            "syncs": len(syncs),
            "counted_leaves": counters.get("nuts.leaves"),
            "live_leaves": counters.get("nuts.live_leaves"),
            "depth_hist": counters.get("nuts.depth_hist"),
            "warmup": warmup,
            "windows": [[s.args["iterations"], s.args["leaves"], _seconds(s)]
                        for s in spans if s.name == "nuts.window"],
            "stages": dict(stages)}


def _mapped(tr, call: int, base_ns: int) -> list:
    """[(start us, end us, depth, name)] of call ``call``'s finished spans
    on the trace's clock, sorted so that a span comes after every span
    that encloses it."""
    depth = {}
    out = []
    for i, s in enumerate(tr.spans):
        depth[i] = 0 if s.parent is None else depth[s.parent] + 1
        if s.call == call and s.end_ns is not None:
            out.append((tr.to_trace_clock(s.start_ns, base_ns), tr.to_trace_clock(s.end_ns, base_ns),
                        depth[i], s.name))
    return sorted(out, key=lambda t: (t[0], t[2]))


def innermost(spans: list, points: list) -> list:
    """The name of the innermost of the nested ``spans`` [(start, end,
    depth, name)] (sorted by start, then depth) around each of the sorted
    ``points`` (``NO_SPAN`` where none is)."""
    names, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][3] if stack else NO_SPAN)
    return names


def idle_gaps_by_span(events, tr, call: int, base_ns: int, k: int = 10) -> list:
    """[[span name, seconds]]: the device's idle gaps between its first and
    last interval (``devtrace.device_intervals``), each named by the
    innermost span of call ``call`` around its midpoint, summed by name,
    longest first."""
    merged = devtrace.device_intervals(events)
    gaps = [(a, b) for (_, a), (b, _) in zip(merged, merged[1:])]
    mids = [0.5 * (a + b) for a, b in gaps]
    order = sorted(range(len(gaps)), key=mids.__getitem__)
    names = innermost(_mapped(tr, call, base_ns), [mids[j] for j in order])
    total = defaultdict(float)
    for j, name in zip(order, names):
        total[name] += (gaps[j][1] - gaps[j][0]) * 1e-6
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def last_call(tr) -> int:
    """The id of the recorder's latest ``sample`` call."""
    ids = [s.call for s in tr.spans if s.name == "sample"]
    return max(ids) if ids else 0



def recorded_call(call, profile: bool = True) -> dict:
    """Runs ``call()`` (one ``sample()`` call) with the recorder on, under
    the card-only profiler unless ``profile`` is False: its summary
    (``draws``), its ms a value+grad call, the seconds it took, trace
    included (``added_s``), and with the profiler the card's idle gaps by
    span.  None where the program has no recorder."""
    t0 = time.perf_counter()
    with recording() as tr:
        if tr is None:
            return None
        out = {}
        if profile:
            events, wall_s, base_ns = record(lambda: out.setdefault("res", call()), cpu=False)
        else:
            out["res"] = call()
    call_id = last_call(tr)
    d = out["res"].diagnostics
    summary = {"draws": call_summary(tr, call_id),
               "ms_per_grad": 1e3 * d["sampler_seconds"] / max(1, d["value_and_grad_calls"]),
               "added_s": time.perf_counter() - t0}
    if profile:
        summary.update(idle_gaps_by_span=idle_gaps_by_span(events, tr, call_id, base_ns),
                       wall_s=wall_s)
    return summary
