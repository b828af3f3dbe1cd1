"""Groups of gloo ranks on the CPU for the sharded port's tests.

``run_group(suite, world, out_dir)`` starts ``world`` processes of

    python -m tests.torch_dist SUITE RANK WORLD STORE OUT_DIR

which join one gloo group through ``parallel.initialize_distributed`` (a
FileStore under ``out_dir``, so that concurrent test workers never share a
port) and run every scenario of the suite in order.  Each scenario returns
a dict of tensors, numbers and strings that is saved as
``OUT_DIR/NAME.RANK.pt``; a test then loads one scenario's outputs of
every rank (``load``).  The group pays its start-up (importing torch, one
rendezvous) once for all of a file's scenarios.

Hangs fail fast: every collective of the group times out after
``COLLECTIVE_TIMEOUT`` seconds, every rank has a wall limit, and when one
rank fails the launcher stops the others at once.

The scenarios import torch and brancher_torch only: no JAX here.  The
JAX side of each comparison runs in the pytest process.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
COLLECTIVE_TIMEOUT = 60.0


# ---------------------------------------------------------------------------
# launcher (pytest process)
def run_group(suite: str, world: int, out_dir: Path, wall_seconds: float = 420.0) -> Path:
    """Run ``suite``'s scenarios on ``world`` gloo ranks; returns
    ``out_dir``.  Raises with the ranks' output when a rank fails or the
    group outlives ``wall_seconds``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / "store"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    logs = [open(out_dir / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist", suite, str(r), str(world), str(store),
         str(out_dir)], cwd=str(REPO), env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + wall_seconds
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad else (
                    f"the group outlived {wall_seconds} s")
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=30)
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r}\n{f.read()[-4000:]}")
        f.close()
    if failed is not None:
        raise RuntimeError(f"{suite} on {world} ranks: {failed}\n" + "\n".join(text))
    return out_dir


def load(out_dir: Path, name: str, world: int) -> list:
    """Scenario ``name``'s outputs, one dict per rank."""
    return [torch.load(Path(out_dir) / f"{name}.{r}.pt", weights_only=False)
            for r in range(world)]


def assert_same_on_every_rank(outs: list) -> None:
    """Every rank's output equals rank 0's bit for bit (but for keys that
    start with "local_": a rank's own counts)."""
    for r, out in enumerate(outs[1:], 1):
        assert out.keys() == outs[0].keys()
        for k, v in out.items():
            if k.startswith("local_"):
                continue
            ref = outs[0][k]
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, ref), f"{k} differs on rank {r}"
            else:
                assert v == ref or (isinstance(v, float) and math.isnan(v) and math.isnan(ref)), (
                    f"{k} differs on rank {r}: {v} vs {ref}")


# ---------------------------------------------------------------------------
# shared by the scenarios and the tests
class Replay:
    """Recorded numbers handed out in order, with ``smc.SMCRandom``'s
    methods (tests/test_torch_smc.py's, without JAX)."""

    generator = None

    def __init__(self, arrays=()):
        self.queue = [np.array(a, np.float32) for a in arrays]
        self.i = 0

    def _next(self, shape):
        a = self.queue[self.i]
        self.i += 1
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.as_tensor(a)

    uniform = normal = gumbel = _next

    def done(self):
        return self.i == len(self.queue)


def replay_lgssm(replay):
    """The default LGSSM with its normals taken from ``replay``."""
    from brancher_torch.inference.smc import StateSpace
    from brancher_torch.models import LGSSMParams, lgssm_state_space

    a, q, _, _, v0 = LGSSMParams()
    base = lgssm_state_space(LGSSMParams())
    return StateSpace(
        init_sample=lambda g, shape: math.sqrt(v0) * replay.normal(shape),
        init_log_prob=base.init_log_prob,
        trans_sample=lambda g, x, t: a * x + math.sqrt(q) * replay.normal(x.shape),
        trans_log_prob=base.trans_log_prob,
        obs_log_prob=base.obs_log_prob,
    )


def filter_numbers(p: int, t_len: int, seed: int):
    """A particle filter's numbers in the port's order: the initial
    normals [P], then per step the resampling uniform and the proposal
    normals [P].  Returns (normals [T, P], uniforms [T - 1])."""
    rs = np.random.RandomState(seed)
    return rs.normal(size=(t_len, p)).astype(np.float32), rs.uniform(size=t_len - 1).astype(np.float32)


def particle_replays(normals, uniforms, rows=slice(None)):
    """(the particles' source: ``rows`` of each step's normals, the
    shared source: the uniforms)."""
    return Replay([n[rows] for n in normals]), Replay([np.float32(u) for u in uniforms])


class KeyedNutsRandom:
    """Vectorized NUTS's numbers as a function of (transition, leaf), for
    a global block of ``chains`` of which this source serves ``rows``: a
    rank's run and an unsharded run over the union then see the same
    numbers for every chain, whatever order their loops ask in.  The
    methods of ``vectorized_nuts.TorchNutsRandom``."""

    def __init__(self, seed: int, chains: int, rows=slice(None)):
        self.seed, self.chains, self.rows = seed, chains, rows
        self.transition = -1

    def _gen(self, *words):
        state = np.random.SeedSequence([self.seed, *words]).generate_state(1)
        return torch.Generator().manual_seed(int(state[0]))

    def momentum(self, z):
        self.transition += 1
        full = torch.randn((self.chains,) + tuple(z.shape[1:]), generator=self._gen(self.transition, 0))
        return full[self.rows].to(z.dtype)

    def leaf(self, n, c, like):
        u = torch.rand((3, self.chains), generator=self._gen(self.transition, 1, n))[:, self.rows]
        return u[0] < 0.5, u[1].to(like.dtype), u[2].to(like.dtype)


def gaussian_vg(scales):
    """value+grad of an independent Gaussian with ``scales`` [d]:
    [C, d] -> ([C], [C, d])."""
    s2 = torch.as_tensor(np.asarray(scales, np.float32)) ** 2

    def vg(z):
        return -0.5 * torch.sum(z * z / s2, -1), -z / s2

    return vg


# ---------------------------------------------------------------------------
# scenarios (rank processes): each takes (world, rank) and returns a dict
def _mesh_scenario(world, rank):
    import torch.distributed as dist
    from brancher_torch.parallel import (
        batch_mesh, chain_mesh, initialize_distributed, make_mesh, particle_mesh, shard_leading_axis,
    )

    out = {}
    initialize_distributed(device="cpu")  # a group exists: a no-op
    out["world_after_second_init"] = dist.get_world_size()
    m = make_mesh({"chain": -1}, device="cpu")
    out["minus_one_shape"] = tuple(m.mesh.shape)
    out["minus_one_names"] = m.mesh_dim_names
    if world % 2 == 0:
        m2 = make_mesh({"chain": 2, "particle": -1}, device="cpu")
        out["two_d_shape"] = tuple(m2.mesh.shape)
        out["two_d_coordinate"] = tuple(m2.get_coordinate())
    try:
        make_mesh({"chain": world + 1}, device="cpu")
        out["too_many"] = "no error"
    except ValueError as e:
        out["too_many"] = str(e)
    for fn in (chain_mesh, particle_mesh, batch_mesh):
        mm = fn(device="cpu")
        out[fn.__name__] = (mm.mesh_dim_names, tuple(mm.mesh.shape))
    sub = make_mesh({"chain": 1}, device="cpu")  # rank 0 only; every rank builds it
    x = {"a": torch.arange(8.0).reshape(4, 2), "b": (torch.arange(4), [torch.ones(4, 3)])}
    try:
        blk = shard_leading_axis(x, sub, "chain")
        out["subset"] = ("in", blk["a"].clone())
    except ValueError as e:
        out["subset"] = ("out", str(e))
    full = shard_leading_axis(x, chain_mesh(device="cpu"), "chain")
    out["block_a"], out["block_b0"], out["block_b1"] = full["a"], full["b"][0], full["b"][1][0]
    try:
        shard_leading_axis(torch.zeros(world + 1), chain_mesh(device="cpu"), "chain")
        out["ragged"] = "no error"
    except ValueError as e:
        out["ragged"] = str(e)
    return out


def _collectives_scenario(world, rank):
    from brancher_torch.ops.resampling import distributed_ess, distributed_logsumexp
    from brancher_torch.parallel import all_gather, chain_mesh, fold_in, mesh_axis, pmax, pmean, psum

    axis = mesh_axis(chain_mesh(device="cpu"), "chain")
    out = {"index": axis.index, "size": axis.size}
    for i, v in enumerate(collective_vectors(world)):
        local = torch.as_tensor(v).reshape(world, -1)[rank]
        out[f"lse{i}"] = distributed_logsumexp(local, axis.group)
        out[f"ess{i}"] = distributed_ess(local, axis.group)
    mine = torch.tensor([float(rank + 1), -float(rank)])
    out["psum"], out["pmax"], out["pmean"] = psum(mine, axis), pmax(mine, axis), pmean(mine, axis)
    out["gather_bool"] = all_gather(torch.tensor([rank % 2 == 0, True]), axis)
    g = torch.Generator().manual_seed(5)
    out["folded"] = torch.randn(3, generator=fold_in(g, rank))
    out["replicated_after_fold"] = torch.randn(3, generator=g)
    g2 = torch.Generator().manual_seed(5)
    out["same_index_again"] = torch.equal(out["folded"], torch.randn(3, generator=fold_in(g2, rank)))
    return out


def _ring_scenario(world, rank):
    from brancher_torch.ops.resampling import ring_exchange
    from brancher_torch.parallel import mesh_axis, particle_mesh

    axis = mesh_axis(particle_mesh(device="cpu"), "particle")
    x, src = ring_inputs(world)
    lp = x.shape[0] // world
    rows = slice(rank * lp, (rank + 1) * lp)
    return {"out": ring_exchange(torch.as_tensor(x[rows]), torch.as_tensor(src[rows]), axis.group)}


def collective_vectors(world):
    """The log-weight vectors the collectives are held to JAX on."""
    rs = np.random.RandomState(world)
    return [(3.0 * rs.normal(size=8 * world)).astype(np.float32),
            np.concatenate([[-np.inf] * world, rs.normal(size=7 * world) - 50.0]).astype(np.float32)]


def ring_inputs(world):
    """x [4 world, 2, 3] and global source rows [4 world] for the ring."""
    rs = np.random.RandomState(10 + world)
    total = 4 * world
    return rs.normal(size=(total, 2, 3)).astype(np.float32), rs.randint(0, total, total).astype(np.int64)


SUITES = {"parallel": [_mesh_scenario, _collectives_scenario, _ring_scenario]}


def register(suite: str):
    """A decorator adding a scenario to ``suite`` (tests/torch_dist_scenarios.py)."""
    def add(fn):
        SUITES.setdefault(suite, []).append(fn)
        return fn

    return add


# ---------------------------------------------------------------------------
# rank process
def _worker(suite: str, rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from brancher_torch.parallel import initialize_distributed

    initialize_distributed(coordinator_address=f"file://{store}", num_processes=world,
                           process_id=rank, device="cpu", timeout_seconds=COLLECTIVE_TIMEOUT)
    import tests.torch_dist_scenarios  # noqa: F401  (registers the sharded runs)

    try:
        for fn in SUITES[suite]:
            name = fn.__name__.strip("_").replace("_scenario", "")
            t0 = time.perf_counter()
            out = fn(world, rank)
            if out is None:
                continue
            torch.save(out, Path(out_dir) / f"{name}.{rank}.pt")
            print(f"{name}: {time.perf_counter() - t0:.2f} s", flush=True)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # leave the group at once: the others fail at their timeout
    dist.destroy_process_group()


if __name__ == "__main__":
    # run in the imported module, whose SUITES the scenario module fills
    from tests.torch_dist import _worker

    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
