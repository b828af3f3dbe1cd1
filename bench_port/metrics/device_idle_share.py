"""device_idle_share (%): 1 - the union of the device's kernel, copy and
set intervals (devtrace.busy, the profiler's trace of the card alone) over
the host's wall seconds of the traced call, one call of the window's
shape."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
