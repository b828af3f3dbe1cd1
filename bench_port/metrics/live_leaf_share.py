"""live_leaf_share (%): of the lockstep leaves the traced call ran over
every chain, the share in which the chain's own tree was still growing:
100 x ``nuts.live_leaves`` / (``nuts.leaves`` x chains), the program's
counters (``spans.call_summary``).  The rest is the work lockstep wastes
on chains that have stopped.  None without the counters."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("draws")
    if not s or not s["counted_leaves"] or s["live_leaves"] is None:
        return None
    return 100.0 * s["live_leaves"] / (s["counted_leaves"] * ctx["chains"])
