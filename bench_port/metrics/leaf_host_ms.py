"""leaf_host_ms: the host's milliseconds a lockstep NUTS leaf outside its
wait at the sync: the mean over the traced call's ``nuts.leaf`` spans of
the leaf less its ``nuts.sync`` (``spans.call_summary``; the program's
recorder, ``brancher_torch.metrics.tracing``).  None without the spans."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("draws")
    if not s or not s["leaves"]:
        return None
    return 1e3 * (s["leaf_s"] - s["leaf_wait_s"]) / s["leaves"]
