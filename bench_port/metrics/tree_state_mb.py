"""tree_state_mb (MB): the bytes of the lockstep NUTS tree's device state
(37 [C, d] tensors and a few [C] ones), in 1e6 bytes: the program's counter
``nuts.tree_state_bytes``, added once a transition, over the traced call's
transitions (``nuts.depth_hist`` counts chains x transitions).  None
without the counter (a call summary that does not carry it, a program
without the recorder, an engine with no lockstep tree)."""


def read(ctx):
    s = (ctx.get("spans") or {}).get("draws")
    if not s or not s.get("tree_state_bytes") or not s.get("depth_hist"):
        return None
    return s["tree_state_bytes"] * ctx["chains"] / sum(s["depth_hist"]) / 1e6
