"""The program's spans and counters in one run of a cell, on the card: what
a traced run of the benchmark reads when the recorder is on.

    python3 bench_port/spanprobe.py --workload <cell> --seed <n> --seconds 5 --pairs 2

In one process: the harness's set-up (kernels, data, model) with the
recorder (``brancher_torch.metrics.tracing``) on for the warmup call; the
call at the window's shape; ``--seconds`` of resumed calls untraced; then
what a traced run does after its window (one call of the window's shape
under the card-only profiler, one of ``trace_draws`` draws under the host's
profiler too) and the call with the recorder on: ``trace_draws`` draws
under the card-only profiler (``spans.recorded_call``), and the same call
with the recorder on and no profiler (CUPTI slows the host's launches, so
this one reads the host loop as it runs in the window).  ``--pairs`` more
turns of ``trace_draws`` calls without the recorder and with it, with no
profiler and under the card-only one, on the same states and keys, give
the recorder's cost.  Prints one JSON line: the per-layer metrics the
readers give (``leaf_host_ms``, ``leaf_wait_ms``, ``live_leaf_share``,
``warmup_grads_per_iter``) from the profiled call and from the bare one,
the warmup call's stages and windows, the idle gaps by span and by host
op, and the costs.  The benchmark's own runs do
not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

METRICS = (("leaf_host_ms", "ms"), ("leaf_wait_ms", "ms"), ("live_leaf_share", "%"),
           ("warmup_grads_per_iter", "calls/iteration"))


def probe(cell, seed: int, seconds: float, pairs: int, device: str = "cuda") -> dict:
    import torch

    import brancher_torch.inference as bti
    from bench_port import devtrace, harness, spans
    from brancher_torch.inference import sample

    cfg, wl = cell.cfg, cell.wl
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        from brancher_torch.ops import cuda_build

        for lib in cfg.get("kernels", []):
            cuda_build.load_library(lib)
    data = cell.model.make_data(cfg, harness.derive(seed, "rows"), device)
    comp = cell.model.build_model(cfg, data).compiled(device)
    chains, per_call = int(wl["chains"]), int(wl["draws_per_call"])
    common = dict(kernel=getattr(bti, wl["kernel"])(**wl["kernel_args"]), num_chains=chains,
                  target_accept=wl["target_accept"], fused_potential=wl["fused_potential"],
                  diagnostics_backend="none")
    sync()
    t0 = time.perf_counter()
    with spans.recording() as tr:
        res = sample(comp, num_warmup=int(wl["num_warmup"]), num_samples=1,
                     key=harness.derive(0, "warmup"), **common)
        sync()
    warmup_s = time.perf_counter() - t0
    warmup = spans.call_summary(tr, spans.last_call(tr)) if tr is not None else None
    state = res.diagnostics["resume_state"]
    res = sample(comp, resume_state=state, num_warmup=0, num_samples=per_call,
                 key=harness.derive(0, "shapes"), **common)
    state = res.diagnostics["resume_state"]
    window = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        res = sample(comp, resume_state=state, num_warmup=0, num_samples=per_call,
                     key=harness.derive(seed, f"call{len(window)}"), **common)
        d = res.diagnostics
        window.append(1e3 * d["sampler_seconds"] / max(1, d["value_and_grad_calls"]))
        state = d["resume_state"]

    def call(n):
        return lambda: sample(comp, resume_state=state, num_warmup=0, num_samples=n,
                              key=harness.derive(seed, "trace"), **common)

    def card_only(n):
        out = {}
        events, wall_s = devtrace.record(lambda: out.setdefault("res", call(n)()), cpu=False)
        d = out["res"].diagnostics
        return events, wall_s, 1e3 * d["sampler_seconds"] / max(1, d["value_and_grad_calls"])

    short = int(wl["trace_draws"])
    ev_dev, wall_s, ms_traced = card_only(per_call)
    t0 = time.perf_counter()
    ev_host, _ = devtrace.record(call(short), cpu=True)
    host_call_s = time.perf_counter() - t0
    by_host_op = devtrace.idle_gaps(ev_host)
    busy_s = devtrace.busy(ev_dev)
    del ev_dev, ev_host
    new = spans.recorded_call(call(short))
    bare = spans.recorded_call(call(short), profile=False)
    turns, bare_turns = [], []
    for _ in range(pairs):
        d = call(short)().diagnostics
        off = 1e3 * d["sampler_seconds"] / max(1, d["value_and_grad_calls"])
        on = spans.recorded_call(call(short), profile=False)
        bare_turns.append([off, on and on["ms_per_grad"]])
        off = card_only(short)[2]
        on = spans.recorded_call(call(short))
        turns.append([off, on and on["ms_per_grad"]])
    suffix = "" if any(m["name"] == "draws_per_s" for m in cell.metrics["end_to_end"]) else ".host"
    entries = [{"name": n + suffix, "unit": u} for n, u in METRICS]

    def metrics(drawn):
        ctx = {"chains": chains, "spans": {"warmup": warmup, "draws": drawn and drawn["draws"]}}
        return harness.read_metrics(entries, ctx)

    return {"workload": cell.name, "seed": seed, "card": harness._card() if cuda else None,
            "metrics": metrics(new), "metrics_unprofiled": metrics(bare),
            "warmup_s": warmup_s, "warmup": warmup, "draws": new and new["draws"],
            "draws_unprofiled": bare and bare["draws"],
            "idle_gaps_by_span": new and new["idle_gaps_by_span"],
            "idle_gaps_by_host_op": by_host_op,
            "busy_s": busy_s, "traced_wall_s": wall_s,
            "ms_per_grad": {"window_median": statistics.median(window) if window else None,
                            "card_only_traced": ms_traced,
                            "recorder_traced": new and new["ms_per_grad"],
                            "turns_off_on": turns, "unprofiled_turns_off_on": bare_turns},
            "added_s": new and new["added_s"], "host_profiled_call_s": host_call_s,
            "run_s": time.perf_counter() - T_START}


if __name__ == "__main__":
    # run.py's environment, set before torch loads: one OMP thread, the
    # compile caches under build/
    from bench_port import run  # noqa: F401

    import torch

    from bench_port import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("spanprobe: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    print(json.dumps(probe(cell, args.seed, args.seconds, args.pairs)), flush=True)
