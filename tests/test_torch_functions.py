"""Port parity: the lifted ``BF`` namespace and ``BrancherFunction``
(brancher_torch.functions against brancher_tpu.functions).

Each lifted function is applied to a variable and constants, through the
JAX package's argument names, and evaluated in both packages on the same
numpy inputs: within 1e-5 relative (1e-6 absolute), f32 elementwise
arithmetic and reductions in two libraries."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu as BJ
import brancher_tpu.functions as BFJ
import brancher_tpu.variables as VJ
import brancher_torch as BT
import brancher_torch.functions as BFT
import brancher_torch.variables as VT
from brancher_torch.bridge import params_to_torch

torch.set_num_threads(2)

R = np.random.RandomState(0)
POS = R.uniform(0.1, 2.0, size=(3, 4)).astype(np.float32)
SIGNED = R.normal(size=(3, 4)).astype(np.float32)
OTHER = R.normal(size=(3, 4)).astype(np.float32)

UNARY = ["exp", "log", "log1p", "sqrt", "abs", "sin", "cos", "tan", "tanh", "sinh", "cosh",
         "erf", "sigmoid", "softplus", "relu", "gelu"]
# name -> (value of the variable "a", further args, kwargs)
CASES = {
    **{n: (POS if n in ("log", "sqrt") else SIGNED, (), {}) for n in UNARY},
    "softmax": (SIGNED, (), {}), "softmax(axis=0)": (SIGNED, (), {"axis": 0}),
    "log_softmax": (SIGNED, (), {"axis": 0}),
    "matmul": (SIGNED, (OTHER.T,), {}), "dot": (SIGNED, (OTHER[0],), {}),
    "dot(2d)": (SIGNED, (OTHER.T,), {}),
    "sum": (SIGNED, (), {}), "sum(axis=1)": (SIGNED, (), {"axis": 1, "keepdims": True}),
    "prod": (POS, (), {"axis": 0}), "mean": (SIGNED, (), {"axis": 1}),
    "max": (SIGNED, (), {}), "max(axis=0)": (SIGNED, (), {"axis": 0}), "min": (SIGNED, (), {"axis": 1}),
    "reshape": (SIGNED, (), {"shape": (4, 3)}),
    "transpose": (SIGNED.reshape(3, 2, 2), (), {}),
    "transpose(axes)": (SIGNED.reshape(3, 2, 2), (), {"axes": (1, 0, 2)}),
    "squeeze": (SIGNED.reshape(3, 1, 4), (), {"axis": 1}),
    "expand_dims": (SIGNED, (), {"axis": 1}),
    "clip": (SIGNED, (-0.5, 0.5), {}),
    "where": (SIGNED, (OTHER,), {}),
    "power": (POS, (2.5,), {}),
    "maximum": (SIGNED, (OTHER,), {}), "minimum": (SIGNED, (OTHER,), {}),
    "take": (SIGNED, (np.array([2, 0]),), {"axis": 1}), "take(flat)": (SIGNED, (np.array([5, 1]),), {}),
    "one_hot": (np.array([0, 3, 1]), (), {"num_classes": 4}),
    "cumsum": (SIGNED, (), {"axis": 1}), "cumsum(flat)": (SIGNED, (), {}),
}


def _eval(pkg_v, link, a):
    return link.fn({"a": a}, pkg_v.ParamStore())


@pytest.mark.parametrize("case", sorted(CASES))
def test_lifted_function_matches_jax(case):
    name = case.split("(")[0]
    a, args, kwargs = CASES[case]
    if name == "where":  # a boolean condition first
        args, a = (a, OTHER), a > 0
    out = []
    for bf, pkg, pkg_v, conv in ((BFJ, BJ, VJ, jnp.asarray), (BFT, BT, VT, torch.as_tensor)):
        var = pkg.DeterministicVariable(a, "a")
        link = getattr(bf, name)(var, *args, **kwargs)
        assert tuple(v.name for v in link.vars) == ("a",)
        out.append(np.asarray(_eval(pkg_v, link, conv(a))))
    ref, got = out
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_einsum_cat_and_stack():
    a = BT.DeterministicVariable(SIGNED, "a")
    store = VT.ParamStore()
    vals = {"a": torch.as_tensor(SIGNED)}
    got = BFT.einsum("ij,kj->ik", a, OTHER).fn(vals, store)
    np.testing.assert_allclose(got.numpy(), np.einsum("ij,kj->ik", SIGNED, OTHER), rtol=1e-5)
    ja = BJ.DeterministicVariable(SIGNED, "a")
    for fn in ("cat", "stack"):
        for axis in (0, 1):
            ref = getattr(BFJ, fn)([ja, OTHER], axis=axis).fn({"a": jnp.asarray(SIGNED)}, VJ.ParamStore())
            got = getattr(BFT, fn)([a, OTHER], axis=axis).fn(vals, store)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert BFT.concat is BFT.cat


def test_brancher_function_lifts_a_callable():
    f = BFT.BrancherFunction(lambda x, scale: scale * torch.tanh(x))
    assert f.name.startswith("<lambda>__fn") and not f.is_module
    a = BT.NormalVariable(0.0, 1.0, "a")
    link = f(a, scale=3.0)
    got = link.fn({"a": torch.tensor([0.5, -1.0])}, VT.ParamStore())
    np.testing.assert_allclose(got.numpy(), 3.0 * np.tanh([0.5, -1.0]), rtol=1e-6)
    assert BFT.BrancherFunction(torch.tanh, name="t").name == "t"


def _dense_model(pkg, bf, net):
    x = pkg.NormalVariable(np.zeros(4, np.float32), np.ones(4, np.float32), "x")
    y = pkg.NormalVariable(bf.BrancherFunction(net, name="net")(x), 0.5, "y")
    y.observe(np.array([0.3, -0.2, 1.1], np.float32))
    return pkg.ProbabilisticModel([y])


def test_module_params_register_lazily_and_match_flax():
    """A module's params register under "<name>__params" in the shape probe,
    as a copy on the model's device; with flax's Dense params carried
    across, the log density and its gradients are JAX's."""
    linear = torch.nn.Linear(4, 3)
    tc = _dense_model(BT, BFT, linear).compiled("cpu")
    mp = tc.initial_params["net__params"]
    assert sorted(mp) == ["bias", "weight"] and mp["weight"].shape == (3, 4)
    assert torch.equal(mp["weight"], linear.weight.detach())
    assert mp["weight"].data_ptr() != linear.weight.data_ptr() and not mp["weight"].requires_grad

    jc = _dense_model(BJ, BFJ, fnn.Dense(3)).compiled()
    jparams = jc.initial_params
    z = np.array([0.4, -1.2, 0.7, 0.1], np.float32)
    ref, ref_g = jax.value_and_grad(lambda p: jc.log_density_z(p, {"x": jnp.asarray(z)}))(jparams)
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = [tparams["net__params"][k].requires_grad_(True) for k in ("weight", "bias")]
    got = tc.log_density_z(tparams, {"x": torch.as_tensor(z)})
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    gw, gb = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ref_g["net__params"]["params"]["kernel"]).T,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(ref_g["net__params"]["params"]["bias"]),
                               rtol=1e-5, atol=1e-6)
