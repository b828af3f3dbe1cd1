"""Port parity: distributions and support transforms (brancher_torch vs
brancher_tpu), on shared numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu.distributions as JD
import brancher_tpu.transforms as JT
import brancher_torch.distributions as TD
import brancher_torch.transforms as TT

torch.set_num_threads(2)

# f32 elementwise math in two libraries: agreement to a few ulps of the
# log-density's magnitude
RTOL, ATOL = 1e-5, 1e-5

_rng = np.random.RandomState(0)
_X = _rng.normal(0, 1.5, size=64).astype(np.float32)
_LOC = _rng.normal(size=64).astype(np.float32)
_SCALE = np.exp(_rng.normal(0, 0.5, size=64)).astype(np.float32)
_LOGITS = _rng.normal(0, 3, size=64).astype(np.float32)
_Y = (_rng.uniform(size=64) < 0.5).astype(np.int32)

CASES = {
    "normal": (JD.Normal(), TD.Normal(), _X, {"loc": _LOC, "scale": _SCALE}),
    "lognormal": (JD.LogNormal(), TD.LogNormal(), np.exp(_X), {"loc": _LOC, "scale": _SCALE}),
    "bernoulli_logits": (JD.Bernoulli(), TD.Bernoulli(), _Y, {"logits": _LOGITS}),
    "bernoulli_probs": (JD.Bernoulli(), TD.Bernoulli(), _Y,
                        {"probs": 1.0 / (1.0 + np.exp(-_LOGITS))}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_prob_matches_jax(case):
    jd, td, value, params = CASES[case]
    ref = np.asarray(jd.log_prob(jnp.asarray(value), **{k: jnp.asarray(v) for k, v in params.items()}))
    got = td.log_prob(torch.as_tensor(value), **{k: torch.as_tensor(v) for k, v in params.items()})
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_softplus_has_no_threshold():
    # torch's softplus returns x above 20; JAX's (and the port's) do not
    x = np.array([-50.0, -5.0, 0.0, 5.0, 19.0, 25.0, 60.0], np.float32)
    got = TD.softplus(torch.as_tensor(x)).numpy()
    ref = np.logaddexp(x.astype(np.float64), 0.0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["Identity", "Exp"])
def test_transform_matches_jax(name):
    jt, tt = getattr(JT, name)(), getattr(TT, name)()
    z = _X
    zj, zt = jnp.asarray(z), torch.as_tensor(z)
    np.testing.assert_allclose(tt.forward(zt).numpy(), np.asarray(jt.forward(zj)), rtol=RTOL)
    np.testing.assert_allclose(tt.forward_log_det(zt).numpy(), np.asarray(jt.forward_log_det(zj)),
                               rtol=RTOL, atol=ATOL)
    x = np.array(jt.forward(zj))
    np.testing.assert_allclose(tt.inverse(torch.as_tensor(x)).numpy(), np.asarray(jt.inverse(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_transform_for_matches_supports():
    assert isinstance(TT.transform_for(TD.Normal()), TT.Identity)
    assert isinstance(TT.transform_for(TD.LogNormal()), TT.Exp)
    with pytest.raises(ValueError):
        TT.transform_for(TD.Bernoulli())


def test_sample_moments_with_generator():
    g = torch.Generator().manual_seed(3)
    loc, scale = torch.tensor(1.5), torch.tensor(0.5)
    x = TD.Normal().sample(g, loc=loc.expand(20000), scale=scale)
    # 20000 draws: standard errors 0.0035 (mean) and 0.0025 (sd)
    assert abs(float(x.mean()) - 1.5) < 0.02 and abs(float(x.std()) - 0.5) < 0.02
    b = TD.Bernoulli().sample(g, logits=torch.zeros(20000))
    assert b.dtype == torch.int32 and abs(float(b.float().mean()) - 0.5) < 0.02
    # the same seed gives the same draws
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    assert torch.equal(TD.LogNormal().sample(g1, loc=loc, scale=scale),
                       TD.LogNormal().sample(g2, loc=loc, scale=scale))
