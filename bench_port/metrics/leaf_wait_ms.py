"""leaf_wait_ms: the host's milliseconds a lockstep NUTS leaf blocked at
``bool(active.any())``: every ``nuts.sync`` span of the traced call (the
one that ends each tree too) over its ``nuts.leaf`` spans
(``spans.call_summary``).  None without the spans."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("draws")
    if not s or not s["leaves"]:
        return None
    return 1e3 * s["wait_s"] / s["leaves"]
