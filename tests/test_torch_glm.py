"""Port parity: fused GLM value+grad (brancher_torch.ops.glm vs
brancher_tpu.ops.pallas_glm).

The plain PyTorch versions are held against the JAX references and
against the JAX Pallas kernels run in interpret mode; the recognizer's
extracted structure against the JAX recognizer's.  The CUDA kernels run
only on a card: see ``test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu as BJ
import brancher_tpu.functions as BFJ
import brancher_tpu.ops.pallas_glm as PG
import brancher_torch as BT
import brancher_torch.functions as BFT
import brancher_torch.ops.glm as G
from brancher_torch.bridge import FUSED_FIELDS, fused_family_from_numpy

torch.set_num_threads(2)

# N not a multiple of the Pallas row block (256), C not a multiple of 8
N, D, C = 300, 7, 13


def _inputs(family, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(N, D)) / np.sqrt(D)).astype(np.float32)
    if family == "bernoulli_logit":
        y = (rng.uniform(size=N) < 0.5).astype(np.float32)
    else:
        y = rng.normal(size=N).astype(np.float32)
    b = (0.3 * rng.normal(size=N)).astype(np.float32)
    z = (0.7 * rng.normal(size=(C, D))).astype(np.float32)
    m = np.linspace(-1, 1, D).astype(np.float32)
    iv = np.linspace(0.5, 2.0, D).astype(np.float32)
    u = np.zeros(D, np.float32)
    u[-1] = 0.5
    return dict(x=x, y=y, b=b, z=z, m=m, iv=iv, u=u, c0=-0.3, ll_scale=1.7)


def _jax_ref(family, dtype, a):
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in a.items()}
    x = j["x"].astype(jnp.bfloat16) if dtype == "bf16" else j["x"]
    if family == "bernoulli_logit":
        fn = PG.bernoulli_vg_reference_bf16 if dtype == "bf16" else PG.bernoulli_vg_reference
        return fn(j["z"], x, j["y"], j["b"], j["m"], j["iv"], j["ll_scale"])
    fn = PG.normal_vg_reference_bf16 if dtype == "bf16" else PG.normal_vg_reference
    return fn(j["z"], x, j["y"], j["b"], j["u"], j["c0"], j["m"], j["iv"], j["ll_scale"])


def _port_plain(family, dtype, a):
    data = G.build_glm_data(family, a["x"], a["y"], a["b"], a["m"], a["iv"],
                            u=a["u"] if family == "normal_learned" else None,
                            c0=a["c0"], ll_scale=a["ll_scale"], dtype=dtype, device="cpu")
    return data, data.plain(torch.as_tensor(a["z"]))


def _close(got, ref, rel):
    """|got - ref| <= rel * max|ref| (errors relative to the output's scale)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.max(np.abs(ref))), 1.0))


# f32: the same arithmetic in two libraries, only summation order differs.
# bf16: a one-ulp difference of sigmoid or loc in f32 can flip the bf16
# rounding of one residual (2^-8 relative), hence the looser bound.
TOL = {"f32": 1e-5, "bf16": 2e-3}
FAMILY_DTYPE = [(f, d) for f in ("bernoulli_logit", "normal_learned") for d in ("f32", "bf16")]


@pytest.mark.parametrize("family,dtype", FAMILY_DTYPE)
def test_plain_matches_jax_reference(family, dtype):
    a = _inputs(family)
    v_ref, g_ref = _jax_ref(family, dtype, a)
    _, (v, g) = _port_plain(family, dtype, a)
    _close(v, v_ref, TOL[dtype])
    _close(g, g_ref, TOL[dtype])


@pytest.mark.parametrize("family,dtype", FAMILY_DTYPE)
def test_plain_matches_pallas_interpret(family, dtype):
    """The TPU kernels themselves, run as tests/test_pallas_glm.py runs
    them on the CPU (block_rows=256, interpret=True)."""
    a = _inputs(family, seed=1)
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in a.items()}
    if family == "bernoulli_logit":
        v_p, g_p = PG.bernoulli_vg_pallas(j["z"], j["x"], j["y"], j["b"], j["m"], j["iv"],
                                          ll_scale=a["ll_scale"], block_rows=256,
                                          interpret=True, dtype=dtype)
    else:
        v_p, g_p = PG.normal_vg_pallas(j["z"], j["x"], j["y"], j["b"], j["u"], a["c0"],
                                       j["m"], j["iv"], ll_scale=a["ll_scale"],
                                       block_rows=256, interpret=True, dtype=dtype)
    _, (v, g) = _port_plain(family, dtype, a)
    _close(v, v_p, TOL[dtype])
    _close(g, g_p, TOL[dtype])


def test_wrapper_takes_cpu_tensors_to_the_plain_version():
    a = _inputs("bernoulli_logit")
    data, (v_ref, g_ref) = _port_plain("bernoulli_logit", "f32", a)
    kernel = G.kernel_for("bernoulli_logit", "f32")
    before = kernel.launches
    vg = G.build_glm_vg("bernoulli_logit", a["x"], a["y"], a["b"], a["m"], a["iv"],
                        ll_scale=a["ll_scale"], device="cpu")
    v, g = vg(torch.as_tensor(a["z"]))
    assert torch.equal(v, v_ref) and torch.equal(g, g_ref)
    assert kernel.launches == before  # no kernel ran
    with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
        kernel(torch.empty((C, D), device="meta"), data)
    assert kernel.launches == before


def test_build_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _inputs("normal_learned")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.build_glm_vg("normal_learned", a["x"], a["y"], a["b"], a["m"], a["iv"], u=a["u"])


def test_flop_and_byte_counts():
    assert G.glm_flops(256, 131072, 1024) == 4 * 256 * 131072 * 1024
    f32 = G.glm_bytes(1024, 1000, 32, 4, "bernoulli_logit")
    bf16 = G.glm_bytes(1024, 1000, 32, 2, "bernoulli_logit")
    assert f32 - bf16 == 1000 * 32 * 2  # only X changes width
    assert G.glm_bytes(1, 1, 8, 4, "normal_learned") - G.glm_bytes(1, 1, 8, 4, "bernoulli_logit") == 32


# ---------------------------------------------------------------------------
# recognizer
# ---------------------------------------------------------------------------

def _logreg(pkg, bf, zeros):
    rng = np.random.RandomState(0)
    x = rng.normal(size=(120, 6)).astype(np.float32)
    y = (rng.uniform(size=120) < 0.5).astype(np.int32)
    w = pkg.NormalVariable(zeros(6), 1.5, "w")
    yv = pkg.BernoulliVariable(logits=bf.matmul(x, w) + 0.2, name="y")
    yv.observe(y)
    return pkg.ProbabilisticModel([yv])


def _conjugate(pkg, bf, zeros):
    mu = pkg.NormalVariable(0.5, 2.0, "mu")
    x = pkg.NormalVariable(mu, 1.3, "x")
    x.observe(np.random.RandomState(1).normal(1.5, 1.3, size=20).astype(np.float32))
    return pkg.ProbabilisticModel([x])


def _lognormal_scale(pkg, bf, zeros):
    mu = pkg.NormalVariable(0.0, 2.0, "mu")
    sigma = pkg.LogNormalVariable(0.0, 0.5, "sigma")
    x = pkg.NormalVariable(mu * 2.0 + 1.0, sigma, "x")
    x.observe(np.random.RandomState(4).normal(1.0, 0.7, size=40).astype(np.float32))
    return pkg.ProbabilisticModel([x])


def _nonlinear(pkg, bf, zeros):
    rng = np.random.RandomState(0)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    w = pkg.NormalVariable(zeros(3), 1.0, "w")
    yv = pkg.BernoulliVariable(logits=bf.matmul(x, bf.exp(w)), name="y")  # nonlinear in w
    yv.observe((rng.uniform(size=50) < 0.5).astype(np.int32))
    return pkg.ProbabilisticModel([yv])


def _hierarchical(pkg, bf, zeros):
    rng = np.random.RandomState(0)
    x = rng.normal(size=(40, 2)).astype(np.float32)
    tau = pkg.LogNormalVariable(0.0, 1.0, "tau")
    w = pkg.NormalVariable(zeros(2), tau, "w")  # prior not a diagonal Gaussian in z
    yv = pkg.BernoulliVariable(logits=bf.matmul(x, w), name="y")
    yv.observe((rng.uniform(size=40) < 0.5).astype(np.int32))
    return pkg.ProbabilisticModel([yv])


def _both(make_model):
    jm = make_model(BJ, BFJ, jnp.zeros)
    tm = make_model(BT, BFT, torch.zeros)
    return jm.compiled(), tm.compiled(device="cpu")


@pytest.mark.parametrize("make_model", [_logreg, _conjugate, _lognormal_scale],
                         ids=["logreg", "conjugate", "lognormal_scale"])
def test_recognizer_matches_jax(make_model):
    jc, tc = _both(make_model)
    jf = PG.recognize_fused_family(jc, jc.initial_params)
    tf = G.recognize_fused_family(tc, tc.initial_params)
    assert jf is not None and tf is not None
    assert tf.family == jf.family
    # probes differ only in f32 rounding of the two graph evaluations
    for field in ("x", "y", "b", "prior_mean", "prior_inv_var"):
        np.testing.assert_allclose(getattr(tf, field).numpy(), np.asarray(getattr(jf, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    if jf.family == "normal_learned":
        np.testing.assert_allclose(tf.u.numpy(), np.asarray(jf.u), atol=1e-5)
        assert tf.c0 == pytest.approx(jf.c0, abs=1e-5)
    assert tf.ll_scale == jf.ll_scale
    # the JAX family, bridged into the port, computes the port's function
    fields = {k: (None if getattr(jf, k) is None else np.asarray(getattr(jf, k)))
              for k in FUSED_FIELDS}
    bridged = fused_family_from_numpy(fields, device="cpu")
    zs = torch.as_tensor(np.random.RandomState(3).normal(size=(5, tc.dim)).astype(np.float32))
    v1, g1 = tf.value_and_grad()(zs)
    v2, g2 = bridged.value_and_grad()(zs)
    _close(v1, v2, 1e-5)
    _close(g1, g2, 1e-5)


@pytest.mark.parametrize("make_model", [_nonlinear, _hierarchical], ids=["nonlinear", "hierarchical"])
def test_recognizer_rejects_what_jax_rejects(make_model):
    jc, tc = _both(make_model)
    assert PG.recognize_fused_family(jc, jc.initial_params) is None
    assert G.recognize_fused_family(tc, tc.initial_params) is None


@pytest.mark.parametrize("error", [RuntimeError("CUDA error: an illegal memory access"),
                                   torch.OutOfMemoryError("CUDA out of memory")],
                         ids=["runtime", "out_of_memory"])
def test_recognizer_passes_device_errors_on(monkeypatch, error):
    """A fault inside a probe is not 'not a GLM': it reaches the caller, so
    sample() never leaves the kernel path without saying why."""
    _, tc = _both(_logreg)

    def failing(*args, **kwargs):
        raise error

    monkeypatch.setattr(tc, "log_prior_z", failing)  # the first probe
    with pytest.raises(type(error), match=str(error)):
        G.recognize_fused_family(tc, tc.initial_params)


def test_recognizer_rejects_a_parameter_not_over_rows():
    """Two observed replicates per row: logits [6] broadcast against y
    [2, 6] in the density, but not over the 12 flattened rows, so the
    recognizer says 'not a GLM' (None) and the autodiff path runs."""
    x = np.random.RandomState(0).normal(size=(6, 4)).astype(np.float32)
    w = BT.NormalVariable(torch.zeros(4), 1.0, "w")
    yv = BT.BernoulliVariable(logits=BFT.matmul(torch.as_tensor(x), w), name="y")
    yv.observe((np.random.RandomState(1).uniform(size=(2, 6)) < 0.5).astype(np.float32))
    tc = BT.ProbabilisticModel([yv]).compiled(device="cpu")
    assert torch.isfinite(tc.log_density_z(tc.initial_params, {"w": torch.zeros(4)}))
    assert G.recognize_fused_family(tc, tc.initial_params) is None
