"""warmup_grads_per_iter (calls/iteration): the lockstep leaves of the
set-up's warmup call (each one value+grad call over every chain) per
warmup iteration, from its ``nuts.warmup`` span (``spans.call_summary``).
None without the spans."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("warmup")
    w = s and s["warmup"]
    if not w or not w["iterations"]:
        return None
    return w["leaves"] / w["iterations"]
