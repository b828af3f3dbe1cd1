"""Structured metrics and profiling hooks.

Counterpart of ``brancher_tpu/metrics.py`` (lines 18-81), under its
names: ``MetricsLogger`` writes a JSONL stream and, where
``torch.utils.tensorboard`` imports, TensorBoard scalars (an import
failure leaves ``_tb`` None, as JAX does with flax's writer);
``profile_trace`` wraps a block in ``torch.profiler`` (the CPU, plus CUDA
when a card is present) and writes a Chrome trace into ``log_dir`` in
place of ``jax.profiler``'s; ``summarize_mcmc`` tabulates an
``MCMCResult``.

``tracing()`` has no JAX counterpart: an in-memory recorder of spans and
counters that ``sample()`` and the lockstep NUTS engine fill at the
boundaries of their work (the names are listed in ``tracing``'s
docstring).  It is off unless a ``with tracing()`` block is open, and then
each instrumented point costs one read of the module global ``_tracer``
and one ``is None`` test: no clock read, no allocation, no
``torch.profiler`` range and no device read.  Spans are stamped with
``time.perf_counter_ns()``; one (``perf_counter_ns``, ``time_ns``) pair
taken when recording starts maps them onto the Unix-time clock of a
``torch.profiler`` Chrome trace (``Tracer.to_trace_clock``), so that they
can be laid over a ``profile_trace`` timeline without any annotation in the
loop.  Recording changes no draw, diagnostic or random stream.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _scalar(v) -> float:
    return float(v) if isinstance(v, torch.Tensor) else float(np.asarray(v))


class MetricsLogger:
    """Append-only JSONL metrics stream + optional TensorBoard."""

    def __init__(self, path: Optional[str] = None, tensorboard_dir: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                self._tb = None

    def log(self, step: int, **metrics) -> None:
        """One record: the step, the wall time and each metric as a float
        (a tensor on the card is read once, here)."""
        values = {k: _scalar(v) for k, v in metrics.items()}
        rec = {"step": int(step), "time": time.time(), **values}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb:
            for k, v in values.items():
                self._tb.add_scalar(k, v, int(step))

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Profile a block with ``torch.profiler`` and write its Chrome trace
    (Perfetto opens it) to ``log_dir/trace.json``; yields ``log_dir``
    (default ``brancher_torch_trace`` under the temporary directory)::

        with profile_trace("trace_dir"):
            sample(model, ...)

    CUDA activities are recorded when a card is present; the block's
    pending card work is waited for before the trace ends."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "brancher_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def summarize_mcmc(result) -> Dict[str, Any]:
    """One entry per variable: mean, sd and, where ``sample()`` computed
    them, ESS and R-hat (numpy)."""
    out = {}
    for name, s in result.samples.items():
        arr = s.detach().cpu().numpy() if isinstance(s, torch.Tensor) else np.asarray(s)
        flat = arr.reshape(arr.shape[0] * arr.shape[1], -1)
        entry = {"mean": flat.mean(0), "sd": flat.std(0)}
        if name in result.diagnostics.get("ess", {}):
            entry["ess"] = np.asarray(result.diagnostics["ess"][name])
            entry["r_hat"] = np.asarray(result.diagnostics["r_hat"][name])
        out[name] = entry
    return out


# -- the span and counter recorder -------------------------------------------

# The recorder of the open ``tracing()`` block; None when recording is off.
# Instrumented code reads it once per point (or once per call of a loop's
# function) and tests it against None.
_tracer: Optional["Tracer"] = None


class Span:
    """One recorded interval: ``name``, ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``; ``end_ns`` None while open), ``parent`` (the
    index of the enclosing span in ``Tracer.spans``, None at the top),
    ``call`` (the call id: 0 outside any traced call) and ``args`` (numbers
    that belong to the span, e.g. a warmup window's leaves)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "args")

    def __init__(self, name, start_ns, end_ns, parent, call, args=None):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent, self.call, self.args = parent, call, args

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}


class Tracer:
    """Spans and counters of one ``tracing()`` block, kept in memory.

    ``spans`` lists every ``Span`` in the order it was opened; a span opened
    or recorded while others are open is the child of the innermost.  A
    traced call (``traced_call``) takes the next call id, and the spans and
    counters recorded inside it carry that id.  ``count`` sums a number
    under the current call id; a tensor is summed where it lives and read
    once, by ``flush`` (``sample()`` flushes at the end of its engine span;
    ``counters`` flushes before it returns)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.clock = (time.perf_counter_ns(), time.time_ns())
        self.call = 0
        self._calls = 0
        self._open: List[int] = []
        self._counters: Dict[int, Dict[str, Any]] = {}
        self._pending: Dict[tuple, torch.Tensor] = {}

    def open(self, name: str, start_ns: Optional[int] = None) -> int:
        """Opens a span under the innermost open one; returns its index."""
        t = time.perf_counter_ns() if start_ns is None else start_ns
        self.spans.append(Span(name, t, None, self._open[-1] if self._open else None, self.call))
        self._open.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def close(self, index: int, end_ns: Optional[int] = None, **args) -> None:
        """Ends span ``index`` (and any span opened inside it and left
        open) at ``end_ns`` (now by default), with ``args``."""
        t = time.perf_counter_ns() if end_ns is None else end_ns
        while self._open and self._open[-1] >= index:
            self.spans[self._open.pop()].end_ns = t
        if args:
            self.spans[index].args = args

    def span(self, name: str, start_ns: int, end_ns: int, parent: Optional[int] = None,
             **args) -> int:
        """Records a finished span, the child of ``parent`` (default: the
        innermost open span); returns its index."""
        if parent is None and self._open:
            parent = self._open[-1]
        self.spans.append(Span(name, start_ns, end_ns, parent, self.call, args or None))
        return len(self.spans) - 1

    @contextlib.contextmanager
    def traced(self, name: str):
        """A span ``name`` around the block, under a new call id."""
        outer = self.call
        self._calls += 1
        self.call = self._calls
        index = self.open(name)
        try:
            yield index
        finally:
            self.close(index)
            self.flush()
            self.call = outer

    def count(self, name: str, value) -> None:
        """Adds ``value`` (a number, or a tensor summed on its device) to
        counter ``name`` of the current call."""
        if isinstance(value, torch.Tensor):
            key = (self.call, name)
            old = self._pending.get(key)
            self._pending[key] = value if old is None else old + value
            return
        calls = self._counters.setdefault(self.call, {})
        calls[name] = calls.get(name, 0) + value

    def flush(self) -> None:
        """Reads the counters that live on a device (one read each) into
        the host's."""
        pending, self._pending = self._pending, {}
        for (call, name), t in pending.items():
            value = t.tolist()
            calls = self._counters.setdefault(call, {})
            old = calls.get(name)
            if old is None:
                calls[name] = value
            elif isinstance(value, list):
                calls[name] = [a + b for a, b in zip(old, value)]
            else:
                calls[name] = old + value

    @property
    def counters(self) -> Dict[int, Dict[str, Any]]:
        """{call id: {counter: value}}; a vector counter is a list."""
        self.flush()
        return self._counters

    def to_trace_clock(self, ns: int, base_ns: int = 0) -> float:
        """``perf_counter_ns`` stamp ``ns`` on a ``torch.profiler`` Chrome
        trace's timeline: microseconds after the trace's
        ``baseTimeNanoseconds`` (its events' ``ts``), by the pair of clocks
        read when recording started."""
        pc0, unix0 = self.clock
        return (ns - pc0 + unix0 - base_ns) * 1e-3

    def to_json(self) -> Dict[str, Any]:
        """The record as one JSON-able object: the clock pair, every span
        (``Span.to_dict``) and the counters by call id."""
        return {"clock": list(self.clock), "spans": [s.to_dict() for s in self.spans],
                "counters": {str(k): v for k, v in self.counters.items()}}

    def chrome_events(self, base_ns: int = 0) -> List[Dict[str, Any]]:
        """The finished spans as Chrome-trace complete events on the
        profiler's clock (``to_trace_clock`` with the trace's
        ``baseTimeNanoseconds``), on a track of their own."""
        return [{"ph": "X", "cat": "brancher_torch", "name": s.name, "pid": os.getpid(),
                 "tid": "brancher_torch.tracing", "ts": self.to_trace_clock(s.start_ns, base_ns),
                 "dur": (s.end_ns - s.start_ns) * 1e-3,
                 "args": dict(s.args or {}, call=s.call)}
                for s in self.spans if s.end_ns is not None]

    def add_to_chrome_trace(self, path: str) -> None:
        """Lays the spans over a Chrome trace that ``profile_trace`` (or
        ``torch.profiler``'s ``export_chrome_trace``) wrote, in place."""
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"].extend(self.chrome_events(int(trace.get("baseTimeNanoseconds", 0))))
        with open(path, "w") as f:
            json.dump(trace, f)


@contextlib.contextmanager
def tracing():
    """Record spans and counters for the block; yields the ``Tracer``.
    Inside an open block it yields that block's recorder and changes
    nothing.  Recording is for the thread that runs the block: the
    recorder is the process's, so calls made meanwhile from other threads
    would be recorded into it too.

    Spans (``sample()`` and the lockstep vectorized NUTS engine):

    - ``sample``: one call of ``sample()``, entry to return; its call id
      covers everything below;
    - ``sample.prepare``: from entry to the engine's start (the potential,
      the GLM recognizer's probe, the initial positions), with the child
      ``sample.recognize``: the recognizer's probe and the fused
      value+grad's build (both cached on the model after its first call);
    - ``sample.engine``: the engine; ``diagnostics["sampler_seconds"]`` is
      its duration;
    - ``vg.capture``: a CUDA-graph capture of the autodiff value+grad
      (``diagnostics["value_and_grad_capture_seconds"]`` sums them);
    - ``nuts.warmup`` (args ``iterations``, ``leaves``), with a
      ``nuts.window`` for each adaptation window of Stan's schedule (the
      initial buffer, each slow window, the terminal buffer; args
      ``iterations``, ``leaves``);
    - ``nuts.draws`` (args ``leaves``): the draws' loop; its duration is
      ``diagnostics["sampling_seconds"]``;
    - ``nuts.leaf``: one leaf of the lockstep tree, from the host's sync
      before it to the end of its issue; its child ``nuts.sync`` is the
      wait at ``bool(active.any())``.  The sync that ends a tree has no
      leaf: it is a ``nuts.sync`` of its own.  In the pipelined sampling
      phase (``NUTS(pipelined=True)``) a ``nuts.leaf`` is one iteration,
      a leaf over every chain, and its ``nuts.sync`` the wait at
      ``bool(working.any())``;
    - ``nuts.leaf_capture``: the capture of a lockstep tree's start and
      leaf into CUDA graphs, after the tree's first transition at a shape;
    - ``sample.constrain``, ``sample.diagnostics``: the rest of the call.

    Counters, per call: ``nuts.leaves`` (leaves run), ``nuts.live_leaves``
    (the sum over leaves of the chains whose own tree was still growing),
    ``nuts.depth_hist`` (chain-draws by the depth of their own tree, 0 to
    ``max_depth``; at ``max_depth`` a tree saturated, Stan's "maximum
    treedepth" warning), ``nuts.graph_leaves`` and ``nuts.eager_leaves``
    (the leaves replayed from a CUDA graph and those run eagerly: their
    sum is ``nuts.leaves``), ``nuts.tree_state_bytes`` (the bytes of the
    lockstep tree's device state, 37 [C, d] tensors and a few [C] ones,
    added once a transition: over a call, the bytes times the
    transitions, which ``nuts.depth_hist`` counts per chain).  The
    pipelined sampling phase adds its iterations to ``nuts.leaves`` and
    its chains' live leaves to ``nuts.live_leaves``.  The counters of the
    NUTS engine are summed on the device and read when ``sample()``'s
    engine span ends."""
    global _tracer
    if _tracer is not None:
        yield _tracer
        return
    tr = Tracer()
    _tracer = tr
    try:
        yield tr
    finally:
        _tracer = None
        tr.flush()


def traced_call(name: str):
    """Decorator: with recording on, each call of the function is a span
    ``name`` under a call id of its own (``Tracer.traced``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            tr = _tracer
            if tr is None:
                return fn(*args, **kwargs)
            with tr.traced(name):
                return fn(*args, **kwargs)

        return call

    return wrap
