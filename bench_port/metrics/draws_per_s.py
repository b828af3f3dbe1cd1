"""draws_per_s: chain-draws completed in the window (chains x draws) over
its wall seconds."""


def read(ctx):
    return ctx["chains"] * ctx["draws"] / ctx["window_s"]
