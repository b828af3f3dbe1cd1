"""Port parity: checkpoint and resume (brancher_torch.checkpoint on
``torch.save`` against brancher_tpu.checkpoint on orbax).

A checkpoint restores exactly what was saved: tensors bit for bit, numbers,
containers, generators (resumed where they stopped) and the particle
methods' states, through ``torch.load(weights_only=True)``.  Resumed runs
are held as JAX's tests hold them: the streaming filter bit for bit with
the uninterrupted run (``tests/test_smc.py:238-273``), the dense-mass
sampler within the JAX test's limits (``tests/test_io_aux.py:50-98``)."""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_torch as BT
from brancher_torch.checkpoint import CheckpointableState, restore_checkpoint, save_checkpoint

torch.set_num_threads(2)


def test_checkpoint_roundtrip_matches_jax(tmp_path):
    """test_io_aux.py::test_checkpoint_roundtrip in both packages."""
    from brancher_tpu.checkpoint import restore_checkpoint as jax_restore
    from brancher_tpu.checkpoint import save_checkpoint as jax_save

    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    state_j = {"params": {"w": jnp.asarray(w)}, "step": jnp.asarray(7)}
    jax_save(str(tmp_path / "jax"), state_j)
    rj = jax_restore(str(tmp_path / "jax"), template=state_j)
    state_t = CheckpointableState(params={"w": torch.as_tensor(w)}, step=torch.tensor(7))
    save_checkpoint(str(tmp_path / "torch"), state_t)
    rt = restore_checkpoint(str(tmp_path / "torch"), template=state_t)
    np.testing.assert_array_equal(rt["params"]["w"].numpy(), np.asarray(rj["params"]["w"]))
    assert int(rt["step"]) == int(rj["step"]) == 7
    assert rt["params"]["w"].dtype == torch.float32


def test_checkpoint_keeps_every_leaf_kind(tmp_path):
    from brancher_torch.inference.smc import SMCRandom

    nt = SMCRandom(torch.Generator().manual_seed(1))
    state = {"t": torch.arange(4, dtype=torch.int32), "a": np.linspace(0, 1, 5),
             "s": np.float32(2.5), "n": 3, "f": 0.5, "b": True, "name": "x", "none": None,
             "list": [torch.ones(2), (1, 2)], "rng": nt}
    save_checkpoint(str(tmp_path), state)
    save_checkpoint(str(tmp_path), state)  # a second save replaces the first whole
    assert sorted(os.listdir(tmp_path)) == ["state.pt"]
    r = restore_checkpoint(str(tmp_path))
    assert torch.equal(r["t"], state["t"]) and r["t"].dtype == torch.int32
    assert isinstance(r["a"], np.ndarray) and np.array_equal(r["a"], state["a"])
    assert r["a"].dtype == np.float64 and r["s"] == 2.5
    assert (r["n"], r["f"], r["b"], r["name"], r["none"]) == (3, 0.5, True, "x", None)
    assert torch.equal(r["list"][0], torch.ones(2)) and r["list"][1] == (1, 2)
    assert type(r["rng"]) is type(nt)
    assert torch.equal(r["rng"].uniform((3,)), nt.uniform((3,)))
    # a template casts each leaf to its dtype
    r = restore_checkpoint(str(tmp_path), template={**state, "t": torch.zeros(4),
                                                    "a": np.zeros(5, np.float32)})
    assert r["t"].dtype == torch.float32 and r["a"].dtype == np.float32


def test_generator_survives_a_weights_only_restore(tmp_path):
    """``torch.load(weights_only=True)`` refuses a pickled generator; the
    checkpoint stores its state and device and rebuilds it, so the draws
    go on where they stopped."""
    g = torch.Generator().manual_seed(11)
    torch.rand(17, generator=g)
    buf = tmp_path / "raw.pt"
    torch.save({"g": g}, buf)
    with pytest.raises(pickle.UnpicklingError):
        torch.load(buf, weights_only=True)
    save_checkpoint(str(tmp_path / "ck"), {"g": g})
    r = restore_checkpoint(str(tmp_path / "ck"))
    assert r["g"].device == g.device
    assert torch.equal(torch.rand(8, generator=r["g"]), torch.rand(8, generator=g))


_TAG = "__brancher_checkpoint__"


def _fill(x, cmd):
    """``x`` with "{cmd}" in each string made ``cmd``."""
    if isinstance(x, dict):
        return {k: _fill(v, cmd) for k, v in x.items()}
    if isinstance(x, list):
        return [_fill(v, cmd) for v in x]
    return x.replace("{cmd}", cmd) if isinstance(x, str) else x


@pytest.mark.parametrize("entry", [
    {_TAG: "state", "class": "os:system", "fields": {}},
    {_TAG: "state", "class": "brancher_torch.checkpoint:os.system", "fields": {"command": "{cmd}"}},
    {_TAG: "state", "class": "system", "fields": {"command": "{cmd}"}},
    {_TAG: "state", "class": "CheckpointableState", "fields": {}},
    {_TAG: "state", "class": "ChainState", "fields": {}},
    {_TAG: "namedtuple", "class": "brancher_torch.checkpoint:os.system", "fields": ["{cmd}"]},
    {_TAG: "object", "class": "os:system", "state": {}},
], ids=["os", "through_the_module", "bare_name", "container", "other_state",
        "namedtuple_kind", "object_kind"])
def test_a_checkpoint_naming_a_foreign_class_is_refused(tmp_path, entry):
    """Restoring rebuilds only the states in the checkpoint's own table: an
    entry naming anything else (a function reached through a module of the
    package, a class of the package that is not such a state, an entry kind
    it does not write) is refused, and nothing it names is called."""
    marker = tmp_path / "ran"
    entry = _fill(entry, f"touch {marker}")
    save_checkpoint(str(tmp_path), {"x": 1})
    torch.save({"x": entry}, tmp_path / "state.pt")
    with pytest.raises(ValueError, match="not one of brancher_torch|unknown checkpoint entry"):
        restore_checkpoint(str(tmp_path))
    assert not marker.exists()
    with pytest.raises(TypeError, match="cannot checkpoint"):
        save_checkpoint(str(tmp_path / "bad"), {"f": lambda: 0})
    from brancher_torch.inference.hmc import ChainState
    with pytest.raises(TypeError, match="cannot checkpoint a ChainState"):
        save_checkpoint(str(tmp_path / "bad"), ChainState(*[torch.zeros(1)] * 3))


def test_streaming_checkpoint_resume_bit_identical(tmp_path):
    """tests/test_smc.py::test_streaming_checkpoint_resume_bit_identical on
    the port: the state (with its draw source) is checkpointed mid-series
    and resumed in a fresh StreamingSMC; the means and the final state
    equal the uninterrupted run's bit for bit."""
    from brancher_torch.inference.streaming_smc import StreamingSMC, StreamingState
    from brancher_torch.models import lgssm_state_space, make_lgssm_data

    _, ys = make_lgssm_data(length=200, seed=5)
    ys = np.asarray(ys)
    ssm = lgssm_state_space()
    kw = dict(num_particles=256, lag=8, chunk_size=50, device="cpu")

    f = StreamingSMC(ssm, **kw)
    state, _ = f.init(ys[0], key=0)
    state, _ = f.process(state, ys[1:101])
    save_checkpoint(str(tmp_path), state)
    state, (m_b, sm_b, _, _) = f.process(state, ys[101:])

    f2 = StreamingSMC(ssm, **kw)
    state2 = restore_checkpoint(str(tmp_path))
    assert isinstance(state2, StreamingState) and state2.t == 101
    state2, (m_b2, sm_b2, _, _) = f2.process(state2, ys[101:])
    assert torch.equal(m_b, m_b2) and torch.equal(sm_b, sm_b2)
    assert state.t == state2.t
    for a, b in zip(state[1:5], state2[1:5]):
        assert torch.equal(a, b)
    assert torch.equal(state.rng.generator.get_state(), state2.rng.generator.get_state())


def test_dense_mass_resume_roundtrip(tmp_path):
    """test_io_aux.py::test_dense_mass_resume_roundtrip on the port: the
    dense resume_state goes through a checkpoint, and the resumed ChEES
    run samples the same correlated Gaussian with no warmup, its adapted
    trajectory length carried (the JAX test's limits)."""
    from brancher_torch.inference import ChEESHMC, sample

    rho, sd = 0.9, (1.0, 2.0)
    z1 = BT.NormalVariable(0.0, sd[0], "z1")
    z2 = BT.NormalVariable(rho * (sd[1] / sd[0]) * z1, float(sd[1] * np.sqrt(1 - rho**2)), "z2")
    model = BT.ProbabilisticModel([z1, z2])
    kw = dict(kernel=ChEESHMC(), num_chains=16, key=0, mass="dense", device="cpu")

    r1 = sample(model, num_samples=300, num_warmup=400, **kw)
    rs = r1.diagnostics["resume_state"]
    assert {"dense_mu", "dense_L", "dense_inner_inv_mass", "trajectory_length"} <= set(rs)
    save_checkpoint(str(tmp_path), rs)
    rs = restore_checkpoint(str(tmp_path), template=rs)

    r2 = sample(model, num_samples=400, resume_state=rs, **kw)
    draws = r2.samples["z2"].numpy().reshape(-1)
    assert np.isfinite(draws).all()
    assert abs(draws.mean()) < 0.25
    assert abs(draws.std() - sd[1]) < 0.4
    assert float(r2.diagnostics["mean_accept_prob"]) > 0.5
    np.testing.assert_allclose(float(r2.diagnostics["trajectory_length"]),
                               float(rs["trajectory_length"]), rtol=1e-6)
    assert "dense_mu" in r2.diagnostics["resume_state"]
