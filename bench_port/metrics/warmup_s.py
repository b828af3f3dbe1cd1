"""warmup_s: wall seconds of the set-up's warmup sample() call, from the
call to its synchronised return."""


def read(ctx):
    return ctx["warmup_s"]
