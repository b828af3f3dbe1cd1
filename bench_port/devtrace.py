"""Reduction of a torch.profiler trace to the device's busy time, the device
operations that took most time, and the device's idle gaps by what the host
was doing.  Apart from ``record``, pure functions of the trace's complete
("X") events, so the tests drive them with synthetic interval lists."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
# a kernel's name is cut to this many characters (templates run to thousands)
NAME_CHARS = 120
# how far back from a gap the search for the host op around it looks
_SCAN = 400


def record(fn, cpu: bool):
    """(the complete events of a profiled ``fn()``, its wall seconds): the
    card's events alone (``cpu=False``, the least cost on the host) or the
    host's too, and the host's clock from a device synchronise before the
    call to one after it.  The trace goes to a temporary file under TMPDIR,
    which is read and deleted."""
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
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return [e for e in events if e.get("ph") == "X" and "dur" in e], wall_s


def device_intervals(events) -> list:
    """The union of the device's kernel, copy and set intervals, in us,
    as sorted disjoint (start, end) pairs."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") in DEVICE_CATS)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def busy(events) -> float:
    """Seconds in which the device ran something: the union of its
    intervals."""
    return sum(b - a for a, b in device_intervals(events)) * 1e-6


def top_device_ops(events, k: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    total = defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            total[e.get("name", "?")[:NAME_CHARS]] += float(e["dur"]) * 1e-6
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(events, k: int = 10) -> list:
    """[[host activity, seconds]]: the device's idle gaps between its first
    and last interval, each named by the innermost host event around its
    midpoint ("python" where none is), summed by name, longest first."""
    merged = device_intervals(events)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
                   for e in events if e.get("cat") in HOST_CATS), key=lambda t: t[0])
    starts = [h[0] for h in host]
    total = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        name = "python"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - _SCAN, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        total[name] += (b - a) * 1e-6
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]
