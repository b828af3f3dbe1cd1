"""setup_s: seconds from the start of the process to the window's start:
import, kernel load (a build on a checkout's first run), data, compile,
the warmup call and one call at the window's shape."""


def read(ctx):
    return ctx["setup_s"]
