"""Port parity: ``sample(resume_state=...)``.

A run's ``diagnostics["resume_state"]`` carries the last draw, the step
size and the mass (ChEES its trajectory length, dense runs the whitening
map and the inner mass), with the keys JAX's carries; a resumed run has
no warmup and goes on from them.  Mirrors ``tests/test_io_aux.py:51-116``
with ``torch.save``/``torch.load`` in place of orbax."""
import io

import jax
import numpy as np
import pytest
import torch

import brancher_tpu.inference as JI
import brancher_tpu.models.conjugate as JCM
import brancher_torch.inference as TI
from brancher_torch import NormalVariable, ProbabilisticModel
from brancher_torch.inference import HMC, NUTS, ChEESHMC, sample
from brancher_torch.models import conjugate_normal_model

torch.set_num_threads(2)

KERNELS = {
    "nuts": (lambda m: m.NUTS(max_depth=4)),
    "hmc": (lambda m: m.HMC(num_integration_steps=4)),
    "chees": (lambda m: m.ChEESHMC(max_leapfrog=8)),
}


@pytest.mark.parametrize("mass", ["diag", "dense"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_resume_state_keys_match_jax(kernel, mass):
    kw = dict(num_samples=6, num_warmup=20, num_chains=3, mass=mass)
    jmodel, _ = JCM.conjugate_normal_model(num_obs=5)
    jres = JI.sample(jmodel, kernel=KERNELS[kernel](JI), key=jax.random.PRNGKey(0), **kw)
    tmodel, _ = conjugate_normal_model(num_obs=5)
    tres = sample(tmodel, kernel=KERNELS[kernel](TI), key=0, device="cpu", **kw)
    jrs, trs = jres.diagnostics["resume_state"], tres.diagnostics["resume_state"]
    assert set(trs) == set(jrs)
    for k in trs:
        assert tuple(trs[k].shape) == tuple(np.shape(jrs[k])), k


def _correlated_2d(rho=0.9, sd=(1.0, 2.0)):
    """tests/test_io_aux.py:61-65's model."""
    z1 = NormalVariable(0.0, sd[0], "z1")
    z2 = NormalVariable(rho * (sd[1] / sd[0]) * z1, float(sd[1] * np.sqrt(1 - rho**2)), "z2")
    return ProbabilisticModel([z1, z2])


def _roundtrip(state):
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return torch.load(buf)


def test_dense_chees_resume_roundtrip():
    """Mirrors tests/test_io_aux.py:51: the checkpoint carries the
    whitening map and the inner mass through a save and load, and the
    resumed run samples the same posterior with no warmup and the adapted
    trajectory length."""
    model = _correlated_2d()
    kw = dict(kernel=ChEESHMC(), num_chains=16, key=0, mass="dense", device="cpu")
    r1 = sample(model, num_samples=300, num_warmup=400, **kw)
    rs = r1.diagnostics["resume_state"]
    assert {"dense_mu", "dense_L", "dense_inner_inv_mass", "trajectory_length"} <= set(rs)
    rs = _roundtrip(rs)

    r2 = sample(model, num_samples=400, resume_state=rs, **kw)
    draws = r2.samples["z2"].reshape(-1).numpy()
    assert np.isfinite(draws).all()
    assert abs(draws.mean()) < 0.25
    assert abs(draws.std() - 2.0) < 0.4
    assert float(r2.diagnostics["mean_accept_prob"]) > 0.5
    np.testing.assert_allclose(float(r2.diagnostics["trajectory_length"]),
                               float(rs["trajectory_length"]), rtol=1e-6)
    assert "dense_mu" in r2.diagnostics["resume_state"]
    assert r2.diagnostics["warmup_leapfrog"] == 0 and "dense_stage_a" not in r2.diagnostics


@pytest.mark.parametrize("kernel", [NUTS(max_depth=5), HMC(num_integration_steps=6)],
                         ids=["nuts", "hmc"])
def test_diag_resume_goes_on_from_the_checkpoint(kernel):
    model, truth = conjugate_normal_model(num_obs=20)
    kw = dict(kernel=kernel, num_chains=8, key=1, device="cpu")
    r1 = sample(model, num_samples=50, num_warmup=200, **kw)
    rs = _roundtrip(r1.diagnostics["resume_state"])
    r2 = sample(model, num_samples=300, resume_state=rs, **kw)
    d = r2.diagnostics
    # no warmup: the checkpoint's step size and mass are used as they are
    assert float(d["step_size"]) == float(rs["step_size"])
    assert torch.equal(d["inv_mass"], rs["inv_mass"])
    assert abs(float(r2.samples["mu"].mean()) - truth["post_mean"]) < 0.05
    assert float(d["mean_accept_prob"]) > 0.5


def test_dense_resume_requires_dense_payload():
    """tests/test_io_aux.py:96-116's two errors."""
    model, _ = conjugate_normal_model(num_obs=5)
    kw = dict(kernel=ChEESHMC(), num_chains=4, key=0, device="cpu")
    r = sample(model, num_samples=50, num_warmup=50, **kw)  # diag run: no dense keys
    with pytest.raises(ValueError, match="dense_mu"):
        sample(model, num_samples=10, mass="dense", resume_state=r.diagnostics["resume_state"], **kw)
    rd = sample(model, num_samples=60, num_warmup=100, mass="dense", **kw)
    with pytest.raises(ValueError, match="mass='dense'"):
        sample(model, num_samples=10, resume_state=rd.diagnostics["resume_state"], **kw)


def test_resume_with_the_wrong_chain_count_or_method_raises():
    model, _ = conjugate_normal_model(num_obs=5)
    kw = dict(kernel=NUTS(max_depth=3), key=0, device="cpu")
    rs = sample(model, num_samples=5, num_warmup=10, num_chains=4, **kw).diagnostics["resume_state"]
    with pytest.raises(ValueError, match="resume_state has 4 chains, expected 3"):
        sample(model, num_samples=5, num_chains=3, resume_state=rs, **kw)
    with pytest.raises(ValueError, match="resume_state is supported with chain_method='vectorized'"):
        sample(model, num_samples=5, num_chains=4, resume_state=rs, chain_method="vmap", **kw)
