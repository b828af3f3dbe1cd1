"""step_mfu (%): the window's value+grad calls times each call's
operations, over the window's wall seconds times the f32 peak: the whole
step's share of the card's peak, whatever runs the potential."""

from bench_port import frozen


def read(ctx):
    w = ctx["work"]
    calls = sum(c["vg_calls"] for c in ctx["calls"])
    return 100.0 * calls * w["flops"] / (ctx["window_s"] * frozen.PEAK_OPS[w["dtype"]])
