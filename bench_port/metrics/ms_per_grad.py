"""ms_per_grad: engine milliseconds per value+grad call, the sum of
sampler_seconds over the sum of value_and_grad_calls: one lockstep leaf or
leapfrog, host and device."""


def read(ctx):
    calls = sum(c["vg_calls"] for c in ctx["calls"])
    if calls == 0:
        return None
    return 1e3 * sum(c["sampler_seconds"] for c in ctx["calls"]) / calls
