"""Port parity: the mesh layer and the sharded filters' collectives
(brancher_torch/parallel, ops/resampling.py vs brancher_tpu's).

A gloo group of 2 and one of 4 CPU ranks (tests/torch_dist.py) build the
meshes and run the collectives once per group; each test reads one of
their outputs.  The JAX side runs here, in ``shard_map`` over a mesh of
the same size taken from conftest's 8 fake CPU devices.  The collectives
agree with JAX's within 1e-6, the ring exchange exactly; make_mesh's
sizes and its error text are JAX's."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from brancher_torch import parallel
from brancher_tpu.ops import resampling as jres
from brancher_tpu.parallel import make_mesh as j_make_mesh
from tests.torch_dist import REPO, collective_vectors, load, ring_inputs, run_group


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def group(request, tmp_path_factory):
    world = request.param
    return world, run_group("parallel", world, tmp_path_factory.mktemp(f"parallel{world}"))


def outputs(group, name):
    world, out_dir = group
    return world, load(out_dir, name, world)


def j_mesh(world):
    return j_make_mesh({"particle": world}, jax.devices()[:world])


def test_make_mesh_sizes_and_minus_one(group):
    world, outs = outputs(group, "mesh")
    for out in outs:
        assert out["minus_one_shape"] == (world,) == tuple(
            j_make_mesh({"chain": -1}, jax.devices()[:world]).devices.shape)
        assert out["minus_one_names"] == ("chain",)
        assert out["two_d_shape"] == (2, world // 2)
    assert [o["two_d_coordinate"] for o in outs] == [(r // (world // 2), r % (world // 2))
                                                     for r in range(world)]


def test_make_mesh_too_many_devices_raises_jax_text(group):
    world, outs = outputs(group, "mesh")
    with pytest.raises(ValueError) as want:
        j_make_mesh({"chain": world + 1}, jax.devices()[:world])
    assert all(o["too_many"] == str(want.value) for o in outs)


def test_axis_meshes_and_second_initialize(group):
    world, outs = outputs(group, "mesh")
    for out in outs:
        assert out["chain_mesh"] == (("chain",), (world,))
        assert out["particle_mesh"] == (("particle",), (world,))
        assert out["batch_mesh"] == (("batch",), (world,))
        assert out["world_after_second_init"] == world


def test_subset_mesh_and_shard_leading_axis(group):
    """A mesh smaller than the world: rank 0 takes the whole leading axis,
    the others are refused; over the whole world each rank takes its
    block of every leaf of the tree; a ragged axis is refused."""
    world, outs = outputs(group, "mesh")
    x = torch.arange(8.0).reshape(4, 2)
    assert outs[0]["subset"][0] == "in" and torch.equal(outs[0]["subset"][1], x)
    assert all(o["subset"][0] == "out" and "not in the mesh" in o["subset"][1] for o in outs[1:])
    lp = 4 // world
    for r, out in enumerate(outs):
        assert torch.equal(out["block_a"], x[r * lp:(r + 1) * lp])
        assert torch.equal(out["block_b0"], torch.arange(4)[r * lp:(r + 1) * lp])
        assert out["block_b1"].shape == (lp, 3)
        assert "must divide" in out["ragged"]


@pytest.mark.parametrize("which", ["lse", "ess"])
def test_collectives_match_jax(group, which):
    world, outs = outputs(group, "collectives")
    fn = jres.distributed_logsumexp if which == "lse" else jres.distributed_ess
    run = jax.jit(shard_map(lambda v: fn(v, "particle"), mesh=j_mesh(world),
                            in_specs=P("particle"), out_specs=P(), check_vma=False))
    for i, v in enumerate(collective_vectors(world)):
        want = float(run(jnp.asarray(v)))
        for out in outs:
            np.testing.assert_allclose(float(out[f"{which}{i}"]), want, rtol=1e-6, atol=1e-6)


def test_psum_pmax_pmean_and_bool_gather(group):
    world, outs = outputs(group, "collectives")
    mine = np.array([[r + 1.0, -float(r)] for r in range(world)], np.float32)
    for r, out in enumerate(outs):
        assert (out["index"], out["size"]) == (r, world)
        np.testing.assert_array_equal(out["psum"].numpy(), mine.sum(0))
        np.testing.assert_array_equal(out["pmax"].numpy(), mine.max(0))
        np.testing.assert_allclose(out["pmean"].numpy(), mine.mean(0), rtol=1e-7)
        assert out["gather_bool"].dtype == torch.bool
        assert out["gather_bool"].tolist() == sum([[r2 % 2 == 0, True] for r2 in range(world)], [])


def test_fold_in_differs_by_rank_and_keeps_the_source_replicated(group):
    world, outs = outputs(group, "collectives")
    folded = [o["folded"] for o in outs]
    assert all(not torch.equal(folded[0], f) for f in folded[1:])
    assert all(torch.equal(outs[0]["replicated_after_fold"], o["replicated_after_fold"]) for o in outs)
    assert all(o["same_index_again"] for o in outs)


def test_ring_exchange_matches_jax_and_take(group):
    world, outs = outputs(group, "ring")
    x, src = ring_inputs(world)
    got = torch.cat([o["out"] for o in outs]).numpy()
    np.testing.assert_array_equal(got, x[src])
    want = jax.jit(shard_map(lambda a, s: jres.ring_exchange(a, s, "particle"), mesh=j_mesh(world),
                             in_specs=(P("particle"), P("particle")), out_specs=P("particle"),
                             check_vma=False))(jnp.asarray(x), jnp.asarray(src.astype(np.int32)))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_initialize_distributed_alone_is_a_noop(monkeypatch):
    import torch.distributed as dist

    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    parallel.initialize_distributed(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        parallel.chain_mesh(device="cpu")


def test_initialize_distributed_needs_a_rank(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="process_id"):
        parallel.initialize_distributed(coordinator_address="127.0.0.1:1", num_processes=2,
                                        device="cpu")


def test_mesh_axis_refuses_what_is_not_a_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        parallel.mesh_axis("chains", "chain")


def test_a_lone_rank_of_two_raises_instead_of_running_alone(tmp_path):
    """JAX's initialize_distributed swallows RuntimeError and ValueError;
    the port's does not: a rank whose peer never comes fails at its
    timeout."""
    code = ("from brancher_torch.parallel import initialize_distributed\n"
            f"initialize_distributed('file://{tmp_path / 'store'}', 2, 0, device='cpu', "
            "timeout_seconds=3)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    done = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0, done.stdout
    assert "timeout" in (done.stderr + done.stdout).lower()
