"""Port parity: the support bijections Sigmoid, Interval and StickBreaking
(brancher_torch.transforms against brancher_tpu's), and their log-dets
against autograd's Jacobian."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu.distributions as JD
import brancher_tpu.transforms as JT
import brancher_torch.distributions as TD
import brancher_torch.transforms as TT

torch.set_num_threads(2)

# f32 elementwise math in two libraries: within 1e-5 of the larger of 1
# and the output's largest magnitude
RTOL = 1e-5

_rng = np.random.RandomState(1)
_Z = _rng.normal(0, 1.5, size=(6, 4)).astype(np.float32)
_LOW = _rng.normal(size=(6, 4)).astype(np.float32)
_HIGH = _LOW + np.exp(_rng.normal(size=(6, 4))).astype(np.float32)


def _pair(name):
    if name == "Interval":
        return JT.Interval(jnp.asarray(_LOW), jnp.asarray(_HIGH)), TT.Interval(
            torch.as_tensor(_LOW), torch.as_tensor(_HIGH))
    return getattr(JT, name)(), getattr(TT, name)()


def _close(got, ref):
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("name", ["Sigmoid", "Interval", "StickBreaking"])
def test_forward_inverse_log_det_match_jax(name):
    jt, tt = _pair(name)
    zj, zt = jnp.asarray(_Z), torch.as_tensor(_Z)
    x = np.asarray(jt.forward(zj))
    _close(tt.forward(zt).numpy(), x)
    _close(tt.forward_log_det(zt).numpy(), jt.forward_log_det(zj))
    _close(tt.inverse(torch.as_tensor(x)).numpy(), jt.inverse(jnp.asarray(x)))
    # the round trip
    np.testing.assert_allclose(tt.inverse(tt.forward(zt)).numpy(), _Z, atol=2e-4)
    assert tuple(tt.unconstrained_shape((6, 5))) == tuple(jt.unconstrained_shape((6, 5)))


@pytest.mark.parametrize("name", ["Sigmoid", "Interval"])
def test_elementwise_log_det_is_the_derivative(name):
    """An elementwise map: its log-det is log f'(z), from autograd in float64."""
    tt = (TT.Interval(torch.as_tensor(_LOW, dtype=torch.float64),
                      torch.as_tensor(_HIGH, dtype=torch.float64))
          if name == "Interval" else TT.Sigmoid())
    z = torch.as_tensor(_Z, dtype=torch.float64).requires_grad_(True)
    d = torch.autograd.grad(tt.forward(z).sum(), z)[0]
    np.testing.assert_allclose(torch.log(d).numpy(), tt.forward_log_det(z.detach()).numpy(),
                               atol=1e-10)


def test_stick_breaking_log_det_is_the_jacobian_of_the_first_k_minus_1_coordinates():
    """The simplex has K-1 free coordinates: the log-det is log|det J| of
    z -> x[:-1], per row, against autograd's Jacobian (float64)."""
    tt = TT.StickBreaking()
    for row in _Z.astype(np.float64):
        z = torch.as_tensor(row)
        jac = torch.autograd.functional.jacobian(lambda v: tt.forward(v)[:-1], z)
        ref = float(torch.linalg.slogdet(jac)[1])
        np.testing.assert_allclose(float(tt.forward_log_det(z)), ref, rtol=1e-10)
    # z = 0 is the uniform simplex point (JAX's offset)
    np.testing.assert_allclose(tt.forward(torch.zeros(3)).numpy(), np.full(4, 0.25), rtol=1e-6)


def test_transform_for_covers_every_support():
    cases = [(TD.Normal(), JD.Normal(), None), (TD.LogNormal(), JD.LogNormal(), None),
             (TD.Beta(), JD.Beta(), None), (TD.Dirichlet(), JD.Dirichlet(), None),
             (TD.Uniform(), JD.Uniform(), {"low": 0.0, "high": 1.0}),
             (TD.TruncatedNormal(), JD.TruncatedNormal(), {"low": 0.0, "high": 1.0}),
             (TD.Concrete(), JD.Concrete(), None), (TD.HalfCauchy(), JD.HalfCauchy(), None)]
    for td, jd, params in cases:
        assert type(TT.transform_for(td, params)).__name__ == type(JT.transform_for(jd, params)).__name__
    for pkg_t, pkg_d in ((TT, TD), (JT, JD)):
        with pytest.raises(ValueError, match="low/high"):
            pkg_t.transform_for(pkg_d.Uniform())
        with pytest.raises(ValueError, match="no unconstraining"):
            pkg_t.transform_for(pkg_d.Poisson())
