"""potential_ms: device milliseconds of one call of the value+grad that
sample() chose, alone after the window at the window's last states and
batch of chains (frozen.time_ms: CUDA events, median of 11 launches after
50 ms of warm-up)."""


def read(ctx):
    return ctx["potential_ms"]
