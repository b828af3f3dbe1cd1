"""sample_overhead_share (%): the share of the window outside the engines,
1 - sum of sample()'s sampler_seconds over the window's wall seconds:
make_potential, the constrain vmap and collection, a call at a time."""


def read(ctx):
    return 100.0 * (1.0 - sum(c["sampler_seconds"] for c in ctx["calls"]) / ctx["window_s"])
