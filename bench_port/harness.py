"""One run of one cell: set-up, the timed window, the trace, the check.

Set-up (``setup_s``, from the start of the process): load the kernel
libraries the configuration names (built into ``build/kernels/`` of the
checkout by the first run), make the data on the device from the seed,
compile the model, run one warmup ``sample()`` call (``warmup_s``), then one
resumed call at the window's shape whose draws are dropped, so that every
shape the window uses is warmed.  The data set is fixed and ``--seed``
orders its rows; the two set-up calls draw from keys of ``setup_seed``, 0
in every run, so that set-up does the same work whatever the seed (with
the seed's keys the warmup's lockstep trees differ by a fifth from seed to
seed); ``dataprobe.py`` runs other data sets and set-up keys.  The window's
calls draw from keys of the seed.  The window calls
``sample(resume_state=<the last call's>, num_warmup=0,
num_samples=draws_per_call, diagnostics_backend="none")`` back to back, each
with its own seed, until ``--seconds`` have passed; the draws of its calls,
joined chain by chain, are one continuous run.  With ``--trace 1`` one more
call of the window's shape runs after the window under the profiler of the
card alone (the device's busy time against that call's wall time), one of
``trace_draws`` draws under the host's profiler too (what the host did in
the device's idle gaps), and the value+grad that ``sample()`` chose is
timed alone at the window's last states.  Then the program's state is
freed and the check (``check.py``) runs against the configuration's plain
reference.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from bench_port import check, devtrace, frozen

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "brancher_tpu")
# the reference's rows of latent states a block (float64 logits of a block
# stay under about 1 GiB)
_REF_ELEMS = 1 << 27


def derive(seed: int, tag: str) -> int:
    """A 60-bit seed for one use (``tag``) of the run's ``--seed``."""
    return int(hashlib.sha256(f"{int(seed)}/{tag}".encode()).hexdigest()[:15], 16)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's (``brancher_torch`` is not ``brancher_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with its files, found by name: the traffic
    ``workloads/<cell>.json``, the configuration's file and its
    ``configs/<config>.py`` and ``configs/<config>_ref.py``."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        self.name, self.entry, self.chips = name, entry, int(entry["chips"])
        with open(root / conf["file"]) as f:
            self.cfg = json.load(f)
        with open(root / "bench_port" / "workloads" / f"{name}.json") as f:
            self.wl = json.load(f)
        base = Path(root / conf["file"]).with_suffix("")
        self.model = load_module(base.with_suffix(".py"), f"bench_port_config_{conf['name']}")
        self.ref = load_module(base.parent / f"{base.name}_ref.py", f"bench_port_ref_{conf['name']}")
        self.metrics = {kind: [m for m in bench[kind] if name in m.get("workloads", [name])]
                        for kind in ("end_to_end", "per_layer")}


def reader_path(name: str, root: Path = ROOT) -> Path:
    """``metrics/<name>.py``, else the reader of the name before its first
    dot: ``draws_per_s.host`` is ``draws_per_s`` read in other cells, under
    a name, and a bound, of its own."""
    path = root / "bench_port" / "metrics" / f"{name}.py"
    return path if path.exists() else path.with_name(f"{name.split('.')[0]}.py")


def read_metrics(entries, ctx: dict, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} from each metric's reader
    (``reader_path``)``::read(ctx)``; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in entries:
        reader = load_module(reader_path(m["name"], root),
                             f"bench_port_metric_{m['name'].replace('.', '_')}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _card() -> dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"nvidia_smi": None}
    return {"nvidia_smi": out}


def _program_vg(comp, diag, dtype=None):
    """The value+grad that ``sample()`` ran, rebuilt from the public entry
    points its diagnostics name: the fused GLM family's (in ``dtype``, by
    default the run's), or the autodiff value+grad of the compiled
    potential.  None when the recognizer no longer finds the run's family."""
    if diag["fused_family"] is not None:
        from brancher_torch.ops.glm import recognize_fused_family

        fam = recognize_fused_family(comp, comp.initial_params)
        if fam is None or fam.family != diag["fused_family"]:
            return None
        return fam.value_and_grad(dtype=dtype or diag["fused_dtype"])
    from brancher_torch.inference.hmc import autodiff_value_and_grad
    from brancher_torch.inference.mcmc import make_potential

    return autodiff_value_and_grad(make_potential(comp, comp.initial_params)[0])


def _at_states(vg, comp, finals):
    """[(values, {name: gradient})] of ``vg`` at each [C, d] batch of states."""
    out = []
    for z in finals:
        v, g = vg(z)
        out.append((v.detach().clone(), {k: t.clone() for k, t in comp.unravel_z(g).items()}))
    return out


def _ref_in_blocks(ref, prep, z: dict):
    """The reference's (values [M], {name: gradient [M, ...]}) over [M, ...]
    states, in blocks."""
    n_rows = prep["x_t"].shape[-1]
    m = next(iter(z.values())).shape[0]
    step = max(1, min(16384, _REF_ELEMS // n_rows))
    vals, grads = [], []
    for i in range(0, m, step):
        v, g = ref.value_and_grad(prep, {k: t[i:i + step] for k, t in z.items()})
        vals.append(v)
        grads.append(g)
    return torch.cat(vals, 0), {k: torch.cat([g[k] for g in grads], 0) for k in grads[0]}


def _planted(ref, prep, uz: dict, z_all) -> dict:
    """The draws' numbers with a fault planted in the window's draws: the
    first latent coordinate shifted by half its standard deviation, every
    coordinate widened 1.25 times about its mean (each read at the moved
    states, with the reference's gradient there), and half of the chains
    left at their first draw."""
    first = ref.LATENTS[0]
    shifted = dict(uz)
    t = uz[first].clone()
    col = t if t.dim() == 1 else t[:, 0]
    col += 0.5 * col.std()
    shifted[first] = t
    widened = {k: v.mean(0) + 1.25 * (v - v.mean(0)) for k, v in uz.items()}
    out = {}
    for name, z in (("draws_shifted", shifted), ("draws_widened", widened)):
        _, g = _ref_in_blocks(ref, prep, z)
        out[name] = check.stein_numbers(check.flat(z, ref.LATENTS, 1), check.flat(g, ref.LATENTS, 1))
    stuck = z_all.clone()
    half = stuck.shape[0] // 2
    stuck[:half] = stuck[:half, :1]
    out["half_chains_unchanged"] = {"rhat_max": check.rhat_max(stuck)}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None, after_setup=None, controls: bool = False,
             setup_seed: int = 0) -> dict:
    """One run; returns {"line": the result object, "numbers": the check,
    "ctx": what the metric readers read}.  ``after_setup`` (tests) runs
    between set-up and the window.  ``controls`` (``control.py``) adds
    "controls": the potential's numbers of the reference in TF32 and in bf16
    put in the program's place, and of the program's own bf16 path where
    the run's potential is a GLM family.  ``setup_seed`` seeds the set-up's
    two ``sample()`` calls."""
    import brancher_torch.inference as bti
    from brancher_torch.inference import sample

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, wl = cell.cfg, cell.wl
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    stages = {}

    def stage(name, t):
        sync()
        stages[name] = time.perf_counter() - t
        return time.perf_counter()

    t = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        from brancher_torch.ops import cuda_build

        for lib in cfg.get("kernels", []):
            cuda_build.load_library(lib)
    t = stage("kernels_s", t)
    data = cell.model.make_data(cfg, derive(seed, "rows"), device)
    t = stage("data_s", t)
    comp = cell.model.build_model(cfg, data).compiled(device)
    t = stage("compile_s", t)
    chains, per_call = int(wl["chains"]), int(wl["draws_per_call"])
    common = dict(kernel=getattr(bti, wl["kernel"])(**wl["kernel_args"]), num_chains=chains,
                  target_accept=wl["target_accept"], fused_potential=wl["fused_potential"],
                  diagnostics_backend="none")
    sync()
    t0 = time.perf_counter()
    res = sample(comp, num_warmup=int(wl["num_warmup"]), num_samples=1,
                 key=derive(setup_seed, "warmup"), **common)
    sync()
    warmup_s = time.perf_counter() - t0
    state = res.diagnostics["resume_state"]
    t = time.perf_counter()
    res = sample(comp, resume_state=state, num_warmup=0, num_samples=per_call,
                 key=derive(setup_seed, "shapes"), **common)
    state = res.diagnostics["resume_state"]
    stage("shapes_s", t)
    if after_setup is not None:
        after_setup()
    sync()
    setup_s = time.perf_counter() - t_start

    # -- the timed window ---------------------------------------------------
    calls, draws, finals = [], [], []
    t0 = time.perf_counter()
    while True:
        res = sample(comp, resume_state=state, num_warmup=0, num_samples=per_call,
                     key=derive(seed, f"call{len(calls)}"), **common)
        d = res.diagnostics
        calls.append({"sampler_seconds": d["sampler_seconds"], "vg_calls": d["value_and_grad_calls"],
                      "host_syncs": d["host_syncs"], "divergences": d["num_divergences"]})
        draws.append(res.samples)
        state = d["resume_state"]
        finals.append(state["z"])
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    diag = res.diagnostics

    # -- the trace: profiled calls after the window --------------------------
    t = time.perf_counter()
    traced = None
    if trace and cuda:
        def call(n):
            return lambda: sample(comp, resume_state=state, num_warmup=0, num_samples=n,
                                  key=derive(seed, "trace"), **common)

        ev_dev, wall_s = devtrace.record(call(per_call), cpu=False)
        ev_host, host_wall_s = devtrace.record(call(int(wl["trace_draws"])), cpu=True)
        busy_s = devtrace.busy(ev_dev)
        if busy_s <= 0.0:  # the card-only trace recorded nothing: the host's
            ev_dev, wall_s = ev_host, host_wall_s
            busy_s = devtrace.busy(ev_host)
        traced = {"busy_s": busy_s, "window_s": wall_s,
                  "device_ops": devtrace.top_device_ops(ev_dev),
                  "idle_gaps": devtrace.idle_gaps(ev_host)}
        del ev_dev, ev_host

    t = stage("trace_s", t)

    # -- the program's potential at the window's states ---------------------
    vg = _program_vg(comp, diag)
    picks = sorted({round(i * (len(finals) - 1) / max(1, int(wl["check_calls"]) - 1))
                    for i in range(int(wl["check_calls"]))})
    checked = [finals[i] for i in picks]
    states = [{k: t_.clone() for k, t_ in comp.unravel_z(z).items()} for z in checked]
    prog = None if vg is None else _at_states(vg, comp, checked)
    potential_ms = (frozen.time_ms(lambda: vg(finals[-1]))
                    if traced is not None and vg is not None else None)
    prog_bf16 = None
    if controls and diag["fused_family"] is not None:
        vg16 = _program_vg(comp, diag, "bf16")
        prog_bf16 = None if vg16 is None else _at_states(vg16, comp, checked)
    sync()
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    names = list(draws[0])
    joined = {n: torch.cat([s[n] for s in draws], 1) for n in names}
    failed = sum(1 for s in draws if not all(bool(torch.isfinite(t).all()) for t in s.values()))
    draws_total = per_call * len(calls)
    min_ess = math.inf
    for n in names:
        x = joined[n].reshape(chains, draws_total, -1)
        for j in range(0, x.shape[-1], 8):
            min_ess = min(min_ess, float(frozen.effective_sample_size(x[..., j:j + 8]).min()))
    work = cell.model.work(cfg, chains, int(comp.dim))
    del vg, res, comp, draws, finals, checked, state, d, diag
    if cuda:
        torch.cuda.empty_cache()
    t = stage("post_window_s", t)

    # -- the check against the plain reference -------------------------------
    ref = cell.ref
    prep = ref.prepare(cfg, data, "f64")
    ref_out = [_ref_in_blocks(ref, prep, s_) for s_ in states]
    numbers = (check.potential_numbers(prog, ref_out, ref.LATENTS) if prog is not None
               else {"grad_err": math.inf, "value_err": math.inf})
    control_numbers = {}
    if controls:
        for prec in ("tf32", "bf16"):
            lowp = ref.prepare(cfg, data, prec)
            control_numbers[f"{prec}_reference"] = check.potential_numbers(
                [_ref_in_blocks(ref, lowp, s_) for s_ in states], ref_out, ref.LATENTS)
        if prog_bf16 is not None:
            control_numbers["program_bf16"] = check.potential_numbers(prog_bf16, ref_out, ref.LATENTS)
    uz = ref.to_unconstrained(joined)
    z_all = check.flat(uz, ref.LATENTS, 2)  # [C, S, d]
    numbers_draws = {}
    gen = torch.Generator(device=z_all.device).manual_seed(derive(seed, "stein"))
    m = z_all.shape[0] * z_all.shape[1]
    pick = torch.randperm(m, generator=gen, device=z_all.device)[: int(wl["stein_states"])]
    z_flat = z_all.reshape(m, -1)[pick]
    uz_pick = {k: t.reshape((m,) + tuple(t.shape[2:]))[pick] for k, t in uz.items()}
    _, g_pick = _ref_in_blocks(ref, prep, uz_pick)
    numbers_draws.update(check.stein_numbers(z_flat, check.flat(g_pick, ref.LATENTS, 1)))
    numbers_draws["rhat_max"] = check.rhat_max(z_all)
    numbers.update(numbers_draws)
    if controls:
        control_numbers.update(_planted(ref, prep, uz_pick, z_all))
    correct, checks = check.judge({n: numbers[n] for n in check.NUMBERS}, wl["limits"])
    stage("check_s", t)

    ctx = {"setup_s": setup_s, "warmup_s": warmup_s, "window_s": window_s, "chains": chains,
           "draws": draws_total, "calls": calls, "min_ess": min_ess, "potential_ms": potential_ms,
           "work": work, "trace": traced, "stages": stages}
    metrics = read_metrics(cell.metrics["per_layer" if trace else "end_to_end"], ctx)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    line = {"correct": bool(correct), "attempted": len(calls), "failed": failed,
            "metrics": metrics, "device": dev}
    if traced is not None:
        line["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    line["card"] = _card() if cuda else {"nvidia_smi": None}
    line["checks"] = checks
    out = {"line": line, "numbers": numbers, "ctx": ctx}
    if controls:
        out["controls"] = control_numbers
    return out


def main(argv, t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = Cell(load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench_port: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 3
    line = out["line"]
    ctx = out["ctx"]
    print("bench_port: " + json.dumps({"stages": ctx["stages"], "calls": len(ctx["calls"]),
                                       "draws": ctx["draws"], "window_s": ctx["window_s"],
                                       "divergences": sum(c["divergences"] for c in ctx["calls"]),
                                       "host_syncs": sum(c["host_syncs"] for c in ctx["calls"]),
                                       "min_ess": ctx["min_ess"],
                                       "ms_per_grad_by_call": [
                                           1e3 * c["sampler_seconds"] / max(1, c["vg_calls"])
                                           for c in ctx["calls"]],
                                       "numbers": out["numbers"]}), file=sys.stderr)
    sys.stdout.flush()
    for n, c in line["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
