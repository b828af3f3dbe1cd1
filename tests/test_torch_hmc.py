"""Port parity: chain-batched HMC and ChEES (brancher_torch vs brancher_tpu).

Deterministic pieces are held to float tolerance: the Halton sequence,
the ChEES trajectory gradient, and short runs of ``hmc_batched`` and
``chees_hmc`` (warmup and draws) with JAX's random stream replayed into
the port (per transition ``split(k, 3)`` into momentum, accept and
length keys for HMC; ``split(k, 2)`` for ChEES).  Whole runs are held to
closed forms with the JAX tests' thresholds (tests/test_chees.py,
tests/test_pallas_glm.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu.inference.chees as JC
import brancher_tpu.ops.batched_hmc as JB
import brancher_tpu.ops.pallas_glm as PG
import brancher_tpu.ops.pallas_leapfrog as PL
import brancher_torch.inference.chees as TC
import brancher_torch.ops.batched_hmc as TB
import brancher_torch.ops.glm as G
import brancher_torch.ops.leapfrog as TL
from brancher_torch.inference import HMC, ChEESHMC, hmc_sample, sample
from brancher_torch.models import conjugate_normal_model

torch.set_num_threads(2)


class JaxStream:
    """The randomness of the JAX engines' transitions for ``key``: the
    warmup keys split from k_warm, then the draw keys from k_samp."""

    def __init__(self, key, c, d, num_warmup, num_samples, length=None):
        k_warm, k_samp = jax.random.split(key)
        keys = list(jax.random.split(k_warm, num_warmup)) if num_warmup else []
        keys += list(jax.random.split(k_samp, num_samples))
        self.draws = []
        for k in keys:
            parts = jax.random.split(k, 3 if length else 2)
            draw = [torch.as_tensor(np.array(jax.random.normal(parts[0], (c, d), jnp.float32))),
                    torch.as_tensor(np.array(jax.random.uniform(parts[1], (c,))))]
            if length:
                draw.append(torch.tensor(int(jax.random.randint(parts[2], (), 1, length + 1))))
            self.draws.append(draw)
        self.i = -1

    def momentum(self, z):
        self.i += 1
        return self.draws[self.i][0]

    def accept(self, c, like):
        return self.draws[self.i][1]

    def num_steps(self, high, device):
        return self.draws[self.i][2]


def _target(seed=0, n=60, d=3):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    b = np.zeros(n, np.float32)
    m = np.zeros(d, np.float32)
    iv = np.full(d, 0.5, np.float32)
    jvg = lambda z: PG.bernoulli_vg_reference(z, *map(jnp.asarray, (x, y, b, m, iv)))
    tvg = lambda z: G.bernoulli_vg_reference(z, *map(torch.as_tensor, (x, y, b, m, iv)))
    return jvg, tvg, d


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def test_halton_matches_jax():
    halton = jax.jit(JC._halton)
    for i in range(100):
        assert TC._halton(i) == float(halton(jnp.int32(i))), i


def test_chees_log_traj_grad_matches_jax():
    rng = np.random.RandomState(0)
    c, d = 12, 4
    z = rng.normal(size=(c, d)).astype(np.float32)
    z1 = rng.normal(size=(c, d)).astype(np.float32)
    v1 = rng.normal(size=(c, d)).astype(np.float32)
    z1[3, 1] = np.inf  # a divergent chain: non-finite position and velocity
    z1[5] = np.nan
    v1[5, 2] = -np.inf
    accept = rng.uniform(size=c) < 0.6
    accept[[3, 5]] = False
    ap = rng.uniform(size=c).astype(np.float32)
    ap[[3, 5]] = 0.0
    want = JC.chees_log_traj_grad(*map(jnp.asarray, (z, z1, v1, accept, ap)), jnp.float32(0.7))
    got = TC.chees_log_traj_grad(*map(torch.as_tensor, (z, z1, v1, accept, ap)), 0.7)
    assert np.isfinite(float(got))
    # the same f32 sums over 12 chains in two libraries
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["loop", "leapfrog_fn"])
def test_hmc_replays_jax_stream(fused):
    jvg, tvg, d = _target(0)
    c, length, warm, draws = 10, 6, 3, 2
    z0 = np.random.RandomState(3).normal(0, 0.5, size=(c, d)).astype(np.float32)
    im0 = np.linspace(0.7, 1.3, d).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kw = dict(num_integration_steps=length, init_step_size=0.3, target_accept=0.8)
    jres = JB.hmc_batched(jvg, jnp.asarray(z0), warm, draws, key, inv_mass0=jnp.asarray(im0),
                          leapfrog_fn=PL.reference_leapfrog(jvg) if fused else None, **kw)
    stream = JaxStream(key, c, d, warm, draws, length)
    tres = TB.hmc_batched(tvg, torch.as_tensor(z0), warm, draws, inv_mass0=torch.as_tensor(im0),
                          leapfrog_fn=TL.reference_leapfrog(tvg) if fused else None,
                          rng=stream, **kw)
    assert stream.i == warm + draws - 1  # every transition drew once
    # f32 arithmetic along the same trajectories: agreement to float noise
    _close(tres.samples, jres.samples)
    _close(tres.accept_prob, jres.accept_prob, atol=1e-5)
    _close(tres.step_size, jres.step_size, rtol=1e-5)
    _close(tres.inv_mass, jres.inv_mass, rtol=1e-5)
    np.testing.assert_array_equal(tres.diverging.numpy(), np.asarray(jres.diverging))
    # the jittered count is read on the host once per transition on both paths
    assert tres.host_syncs == warm + draws
    assert tres.used_leapfrog_fn is fused


@pytest.mark.parametrize("mass,fused", [("diag", False), ("diag", True), ("dense", False),
                                        ("dense", True)],
                         ids=["diag-loop", "diag-leapfrog_fn", "dense", "dense-leapfrog_fn"])
def test_chees_replays_jax_stream(mass, fused):
    jvg, tvg, d = _target(1)
    c, warm, draws = 12, 3, 2
    z0 = np.random.RandomState(5).normal(0, 0.5, size=(c, d)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    kw = dict(init_step_size=0.3, init_trajectory_length=1.1, mass=mass, max_leapfrog=9)
    jres = JC.chees_hmc(jvg, jnp.asarray(z0), warm, draws, key,
                        leapfrog_fn=PL.reference_leapfrog(jvg) if fused else None, **kw)
    stream = JaxStream(key, c, d, warm, draws)
    tres = TC.chees_hmc(tvg, torch.as_tensor(z0), warm, draws,
                        leapfrog_fn=TL.reference_leapfrog(tvg) if fused else None, rng=stream, **kw)
    assert stream.i == warm + draws - 1
    np.testing.assert_array_equal(tres.num_leapfrog.numpy(), np.asarray(jres.num_leapfrog))
    assert int(tres.warmup_leapfrog) == int(jres.warmup_leapfrog)
    _close(tres.samples, jres.samples)
    _close(tres.accept_prob, jres.accept_prob, atol=1e-5)
    _close(tres.step_size, jres.step_size, rtol=1e-5)
    _close(tres.trajectory_length, jres.trajectory_length, rtol=1e-5)
    _close(tres.inv_mass, jres.inv_mass, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tres.diverging.numpy(), np.asarray(jres.diverging))
    # dense mass drops leapfrog_fn, as the JAX engine does, and says so
    assert tres.used_leapfrog_fn is (fused and mass == "diag")


def test_hmc_loop_path_flags_divergences_without_a_host_sync():
    """Too large a step against a low energy limit: the loop path, which
    checks the energy error after every step, flags divergences; a fixed
    step count is never read back from the device."""
    _, tvg, d = _target(2)
    z0 = torch.zeros((6, d))
    kw = dict(num_integration_steps=8, jitter_steps=False, init_step_size=3.0,
              max_delta_energy=5.0, generator=torch.Generator().manual_seed(0))
    res = TB.hmc_batched(tvg, z0, 0, 3, **kw)
    assert bool(res.diverging.any())
    assert res.host_syncs == 0  # a fixed count needs no read from the device


# ---------------------------------------------------------------------------
# whole runs against closed forms (thresholds of the JAX tests)
# ---------------------------------------------------------------------------

def test_chees_conjugate():
    model, truth = conjugate_normal_model(num_obs=20)
    res = sample(model, kernel=ChEESHMC(), num_samples=600, num_warmup=500,
                 num_chains=32, key=0, device="cpu")
    assert abs(float(res.samples["mu"].mean()) - truth["post_mean"]) < 0.05
    assert abs(float(res.samples["mu"].var(unbiased=False)) - truth["post_var"]) < 0.03
    assert float(res.diagnostics["mean_accept_prob"]) > 0.6
    d = res.diagnostics
    assert d["fused_family"] == "normal_learned" and not d["fused_leapfrog"]
    assert d["total_leapfrog_steps"] == int(res.stats["num_steps"].sum())
    assert d["warmup_leapfrog"] > 0 and float(d["trajectory_length"]) > 0
    # num_steps: the shared leapfrog count per draw, broadcast per chain
    assert torch.equal(res.stats["num_steps"][0], res.stats["num_steps"][-1])


def test_chees_learns_trajectory():
    """Anisotropic Gaussian: variances must match across 3 orders of
    magnitude (needs both mass and trajectory adaptation)."""
    scales = torch.tensor([0.1, 1.0, 10.0])

    def vg(z):
        return -0.5 * torch.sum((z / scales) ** 2, -1), -z / scales**2

    gen = torch.Generator().manual_seed(2)
    z0 = 0.1 * torch.randn((64, 3), generator=gen)
    res = TC.chees_hmc(vg, z0, 600, 600, gen)
    var = res.samples.reshape(-1, 3).var(0, unbiased=False).numpy()
    np.testing.assert_allclose(var, scales.numpy() ** 2, rtol=0.3)
    assert float(res.trajectory_length) > 0.5


def test_chees_dense_mass_correlated_target():
    """rho=0.95 correlated Gaussian: dense mass recovers the covariance."""
    cov = torch.tensor([[1.0, 0.95], [0.95, 1.0]])
    prec = torch.linalg.inv(cov)

    def vg(z):
        return -0.5 * torch.einsum("cd,de,ce->c", z, prec, z), -z @ prec

    gen = torch.Generator().manual_seed(3)
    z0 = 0.1 * torch.randn((64, 2), generator=gen)
    res = TC.chees_hmc(vg, z0, 600, 600, gen, mass="dense")
    emp = np.cov(res.samples.reshape(-1, 2).numpy().T)
    np.testing.assert_allclose(emp, cov.numpy(), atol=0.12)
    assert float(res.accept_prob.mean()) > 0.6


def test_hmc_with_fused_leapfrog_posterior():
    """HMC driven by the family's integrator recovers the conjugate
    posterior; on the CPU that is the plain loop, and sample() says so."""
    model, truth = conjugate_normal_model(num_obs=20)
    with pytest.warns(UserWarning, match="fused_leapfrog=True was requested"):
        res = sample(model, kernel=HMC(num_integration_steps=16), num_samples=600,
                     num_warmup=400, num_chains=32, key=1, fused_leapfrog=True, device="cpu")
    comp = model.compiled(device="cpu")
    assert getattr(comp, "_fused_leapfrog_built", None) is not None
    assert res.diagnostics["fused_leapfrog"] is False
    assert abs(float(res.samples["mu"].mean()) - truth["post_mean"]) < 0.05
    assert abs(float(res.samples["mu"].var(unbiased=False)) - truth["post_var"]) < 0.03
    # HMC's num_steps is the JAX package's (L+1)//2 per draw, not the drawn count
    assert int(res.stats["num_steps"][0, 0]) == 8


def test_hmc_sample_takes_the_kernel_settings_as_keywords():
    model, _ = conjugate_normal_model(num_obs=20)
    res = hmc_sample(model, num_integration_steps=4, jitter_steps=False, target_accept=0.7,
                     num_samples=20, num_warmup=20, num_chains=4, key=0, device="cpu")
    assert bool((res.stats["num_steps"] == 4).all())
    assert res.diagnostics["host_syncs"] == 0  # a fixed count is never read back
