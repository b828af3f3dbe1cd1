"""Port parity: model serialization (brancher_torch.serialization against
brancher_tpu.serialization), ports of ``tests/test_serialization.py``.

The spec is the same JSON in both packages, key for key: a spec either
package writes builds in the other, and the rebuilt model's log density
at a fixed z equals the original's within 1e-5 (1e-4 for the HMM's
forward recursion, as the JAX test holds it).  Pickled models keep their
log densities exactly; a model pickled with tensors on the card is
restored onto the device ``load_model`` is given (the card test is in
``test_torch_kernels_cuda.py``)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_torch as BT
import brancher_torch.functions as BFT
import brancher_tpu as BJ
import brancher_tpu.functions as BFJ
from brancher_torch.serialization import (
    build_model,
    load_model,
    model_spec,
    save_model,
    save_spec,
    spec_matches,
)

torch.set_num_threads(2)
DATA = (np.random.RandomState(0).randn(20) + 2).astype(np.float32)


def _build(P, BF):
    """tests/test_serialization.py::_build."""
    mu = P.NormalVariable(0.0, 2.0, "mu")
    sigma = P.LogNormalVariable(0.0, 0.5, "sigma")
    x = P.NormalVariable(BF.exp(mu * 0.1) + mu, sigma, "x")
    x.observe(DATA)
    return P.ProbabilisticModel([x])


def _plain(P, BF):
    mu = P.NormalVariable(0.0, 2.0, "mu")
    sigma = P.LogNormalVariable(0.0, 0.5, "sigma")
    x = P.NormalVariable(mu, sigma, "x", plate_shape=(20,))
    x.observe(np.random.RandomState(0).randn(20).astype(np.float32))
    return P.ProbabilisticModel([x])


def _hmm(P, BF):
    """tests/test_serialization.py::test_build_model_stateful_distribution."""
    import importlib

    sp = importlib.import_module(P.__name__ + ".stochastic_processes")
    arr = np.asarray
    locs = P.NormalVariable(np.zeros(2, np.float32), 5.0 * np.ones(2, np.float32), "locs")
    series = sp.HMMVariable(30, init_logits=np.zeros(2, np.float32),
                           trans_logits=np.log(arr([[0.9, 0.1], [0.2, 0.8]], np.float32)),
                           locs=locs, scales=arr([0.7, 0.7], np.float32), name="y")
    series.observe(np.random.RandomState(1).randn(30).astype(np.float32))
    return P.ProbabilisticModel([series])


def _leaves(P, BF):
    """Deterministic leaves (a learnable one among them), a variable-valued
    deterministic node, a plate and a log-prob scale."""
    scale = P.DeterministicVariable(np.float32(1.5), "scale", learnable=True)
    loc = P.DeterministicVariable(np.asarray([0.0, 1.0], np.float32), "loc")
    alias = P.DeterministicVariable(scale, "alias")
    z = P.NormalVariable(loc, alias, "z")
    w = P.RandomVariable(P.NormalVariable(0.0, 1.0, "tmp").distribution, name="w",
                         links={"loc": z, "scale": 2.0}, plate_shape=(3,), log_prob_scale=0.5)
    return P.ProbabilisticModel([w])


MODELS = {"plain": (_plain, {"mu": 0.3, "sigma": -0.2}, 1e-5),
          "hmm": (_hmm, {"locs": [0.5, -0.5]}, 1e-4),
          "leaves": (_leaves, {"z": [0.2, -0.4], "w": np.linspace(-1, 1, 6).reshape(3, 2)}, 1e-5)}


def _log_density(model, z, pkg):
    if pkg == "jax":
        comp = model.compiled()
        return float(comp.log_density_z(comp.initial_params,
                                        {k: jnp.asarray(v, jnp.float32) for k, v in z.items()}, None))
    comp = model.compiled("cpu")
    return float(comp.log_density_z(comp.initial_params,
                                    {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in z.items()}))


def test_save_load_roundtrip(tmp_path):
    """test_serialization.py::test_save_load_roundtrip: the loaded model
    has the same variables and log probability, and samples."""
    from brancher_torch.inference import sample

    model = _build(BT, BFT)
    vals = {"mu": np.asarray([0.5], np.float32), "sigma": np.asarray([1.0], np.float32)}
    lp = model.calculate_log_probability(vals, device="cpu")
    model.compiled("cpu")  # a compiled model in the cache is left out of the file
    p = os.path.join(tmp_path, "model.pkl")
    save_model(model, p)
    assert model._compiled_cache
    loaded = load_model(p, device="cpu")
    assert loaded._compiled_cache == {}
    assert [v.name for v in loaded.variables] == [v.name for v in model.variables]
    assert torch.equal(loaded.calculate_log_probability(vals, device="cpu"), lp)
    jax_lp = np.asarray(_build(BJ, BFJ).calculate_log_probability(
        {k: jnp.asarray(v) for k, v in vals.items()}))
    np.testing.assert_allclose(lp.numpy(), jax_lp, rtol=1e-5)
    res = sample(loaded, num_samples=100, num_warmup=100, num_chains=2, key=0, device="cpu")
    assert np.isfinite(float(torch.mean(res.samples["mu"])))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(p)  # the default device is the card: no quiet fallback to the CPU


def test_spec_roundtrip(tmp_path):
    """test_serialization.py::test_spec_roundtrip, with JAX's file read by
    the port."""
    model = _build(BT, BFT)
    p = os.path.join(tmp_path, "spec.json")
    save_spec(model, p, device="cpu")
    spec = json.load(open(p))
    assert spec_matches(model, spec, device="cpu")
    names = {v["name"]: v for v in spec["variables"]}
    assert names["x"]["observed"] and names["x"]["distribution"] == "Normal"
    assert names["sigma"]["distribution"] == "LogNormal"
    other = BT.ProbabilisticModel([BT.NormalVariable(0.0, 1.0, "mu")])
    assert not spec_matches(other, spec, device="cpu")
    # the spec JAX's save_spec writes for the same model is this one
    from brancher_tpu.serialization import save_spec as jax_save_spec

    pj = os.path.join(tmp_path, "jax_spec.json")
    jax_save_spec(_build(BJ, BFJ), pj)
    assert open(pj).read() == open(p).read()
    assert spec_matches(model, json.load(open(pj)), device="cpu")


@pytest.mark.parametrize("name", list(MODELS))
def test_spec_with_links_equals_jax(name):
    from brancher_tpu.serialization import model_spec as jax_model_spec

    make = MODELS[name][0]
    spec_t = model_spec(make(BT, BFT), include_links=True, device="cpu")
    spec_j = jax_model_spec(make(BJ, BFJ), include_links=True)
    assert json.dumps(spec_t, sort_keys=True) == json.dumps(spec_j, sort_keys=True)


@pytest.mark.parametrize("name", list(MODELS))
def test_build_model_round_trip(name, tmp_path):
    """test_serialization.py::test_build_model_round_trip and
    ::test_build_model_stateful_distribution (the HMM), plus the spec that
    JAX writes: built in the port, the same log density as the original
    in both packages."""
    from brancher_tpu.serialization import model_spec as jax_model_spec

    make, z, tol = MODELS[name]
    model = make(BT, BFT)
    spec = json.loads(json.dumps(model_spec(model, include_links=True, device="cpu")))
    rebuilt = build_model(spec)
    assert spec_matches(rebuilt, model_spec(model, device="cpu"), device="cpu")
    want = _log_density(model, z, "torch")
    assert abs(_log_density(rebuilt, z, "torch") - want) <= tol * max(1.0, abs(want))

    p = tmp_path / "jax_spec.json"
    p.write_text(json.dumps(jax_model_spec(make(BJ, BFJ), include_links=True)))
    from_jax = build_model(json.loads(p.read_text()))
    got = _log_density(from_jax, z, "torch")
    ref = _log_density(make(BJ, BFJ), z, "jax")
    assert abs(got - want) <= tol * max(1.0, abs(want))
    assert abs(got - ref) <= tol * max(1.0, abs(ref)), (got, ref)


def test_build_model_opaque_link_raises():
    mu = BT.NormalVariable(0.0, 1.0, "mu")
    x = BT.NormalVariable(BFT.exp(mu) + 1.0, 1.0, "x")
    spec = model_spec(BT.ProbabilisticModel([x]), include_links=True, device="cpu")
    assert spec["variables"][-1]["links"]["loc"]["kind"] == "opaque"
    with pytest.raises(ValueError, match="opaque.*save_model"):
        build_model(spec)
    with pytest.raises(ValueError, match="include_links"):
        build_model(model_spec(BT.ProbabilisticModel([x]), device="cpu"))


def test_distribution_registry_has_jax_names():
    """Every Distribution class of JAX's registry exists in the port's under
    the same name (a spec names its classes)."""
    from brancher_torch.serialization import _dist_registry as tr
    from brancher_tpu.serialization import _dist_registry as jr

    assert set(jr()) <= set(tr())
