"""grads_per_draw: value+grad calls of the window (sample()'s
value_and_grad_calls, each over every chain) per draw of a chain."""


def read(ctx):
    return sum(c["vg_calls"] for c in ctx["calls"]) / ctx["draws"]
