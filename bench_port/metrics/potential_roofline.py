"""potential_roofline (%): the least time of one value+grad call over
potential_ms.  The least time is the larger of the call's operations at the
f32 peak and its bytes at the memory peak (frozen.bound; the configuration's
``work`` counts them from the shapes, so it reads the same work whatever
implements the potential)."""

from bench_port import frozen


def read(ctx):
    if not ctx["potential_ms"]:
        return None
    w = ctx["work"]
    return 100.0 * frozen.bound(w["bytes"], w["flops"], w["dtype"])["bound_ms"] / ctx["potential_ms"]
