"""Port parity: the fused leapfrog (K5) and the logreg value+grad (K6).

The plain versions are held against the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU
(tests/test_pallas_glm.py, tests/test_pallas_ops.py), and against the
JAX references.  The CUDA kernels run only on a card:
``test_torch_kernels_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brancher_tpu.ops.pallas_glm as PG
import brancher_tpu.ops.pallas_logreg as PLR
from brancher_tpu.models import conjugate_normal_model as j_conj
from brancher_tpu.models import logistic_regression_model as j_logreg
from brancher_tpu.models import make_logreg_data
from brancher_torch.inference import ChEESHMC, sample
import brancher_torch.ops.glm as G
import brancher_torch.ops.leapfrog as TL
import brancher_torch.ops.logreg as TLR
from brancher_torch.models import conjugate_normal_model as t_conj
from brancher_torch.models import logistic_regression_model as t_logreg

torch.set_num_threads(2)


def _families(name):
    """The recognized family of one model in both packages."""
    if name == "bernoulli_logit":
        x, y, _ = make_logreg_data(100, 6, seed=0)
        jm, tm = j_logreg(x, y), t_logreg(x, y)
    else:
        jm, tm = j_conj()[0], t_conj()[0]
    jc, tc = jm.compiled(), tm.compiled(device="cpu")
    jf = PG.recognize_fused_family(jc, jc.initial_params)
    tf = G.recognize_fused_family(tc, tc.initial_params)
    assert jf.family == tf.family == name
    return jf, tf


@pytest.mark.parametrize("n_steps", [1, 7])
@pytest.mark.parametrize("family", ["bernoulli_logit", "normal_learned"])
def test_plain_leapfrog_matches_pallas_interpret(family, n_steps):
    jf, tf = _families(family)
    d = tf.x.shape[1]
    rng = np.random.RandomState(0)
    z = (0.3 * rng.normal(size=(16, d))).astype(np.float32)
    r = rng.normal(size=(16, d)).astype(np.float32)
    inv_mass = np.linspace(0.5, 1.5, d).astype(np.float32)
    _, g0 = jf.value_and_grad(use_pallas=False)(jnp.asarray(z))
    want = jf.leapfrog(use_pallas=True, interpret=True)(
        jnp.asarray(z), jnp.asarray(r), g0, 0.05, jnp.asarray(inv_mass), n_steps)
    got = tf.leapfrog()(*map(torch.as_tensor, (z, r, np.array(g0))), 0.05,
                        torch.as_tensor(inv_mass), n_steps)
    # as tests/test_pallas_glm.py holds the kernel to its XLA loop
    for name, a, b in zip(("z", "r", "val", "grad"), got, want):
        atol = 1e-3 if name == "val" else 1e-4
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=atol, err_msg=name)


def test_fused_leapfrog_on_the_cpu_is_the_plain_loop():
    _, tf = _families("bernoulli_logit")
    lf = TL.build_fused_leapfrog(tf.family, tf.x, tf.y, tf.b, tf.prior_mean, tf.prior_inv_var,
                                 ll_scale=tf.ll_scale, device="cpu")
    assert isinstance(lf, TL.FusedLeapfrog) and lf.host_syncs_per_call == 0
    z = torch.as_tensor(np.random.RandomState(1).normal(0, 0.3, (5, 6)).astype(np.float32))
    r, (_, g) = torch.ones_like(z), tf.plain(z)
    im, steps = torch.ones(6), torch.tensor(3, dtype=torch.int32)
    before = TL.LEAPFROG.launches
    got = lf(z, r, g, torch.tensor(0.1), im, steps)
    want = TL.reference_leapfrog(tf.plain)(z, r, g, 0.1, im, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert TL.LEAPFROG.launches == before  # no kernel ran
    # no step: the inputs come back and val is 0, as in JAX
    z0, r0, v0, g0 = lf(z, r, g, 0.1, im, 0)
    assert torch.equal(z0, z) and torch.equal(r0, r) and torch.equal(g0, g)
    assert not bool(v0.any())
    with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
        TL.LEAPFROG(lf.data, torch.empty((5, 6), device="meta"), r, g, 0.1, im, 1)


def test_size_gate_is_hoppers_shared_memory():
    """X (odd row stride) and one chain's state must fit in the 232,448
    bytes of shared memory a block may opt in to on an H100."""
    assert TL.leapfrog_smem_bytes(1000, 32, 1) == 4 * (1000 * 33 + 3 * 32 + 32)
    assert TL.leapfrog_fits(1000, 32)  # the floor shape, 132 KB
    assert TL.leapfrog_fits(20, 1)  # the conjugate shape
    assert not TL.leapfrog_fits(131072, 1024)  # the MXU-scale GLM
    assert not TL.leapfrog_fits(1760, 32) and TL.leapfrog_fits(1750, 32)
    rng = np.random.RandomState(2)
    big = rng.normal(size=(2000, 32)).astype(np.float32)
    args = (np.zeros(2000, np.float32), np.zeros(2000, np.float32),
            np.zeros(32, np.float32), np.ones(32, np.float32))
    assert TL.build_fused_leapfrog("bernoulli_logit", big, *args, device="cpu") is None
    assert TL.build_fused_leapfrog("bernoulli_logit", big[:1000], *(a[:1000] if a.size == 2000 else a
                                                                    for a in args), device="cpu")


def test_leapfrog_counts():
    assert TL.leapfrog_flops(1024, 1000, 32, 8) == 8 * G.glm_flops(1024, 1000, 32)
    nb = TL.leapfrog_bytes(1024, 1000, 32, "bernoulli_logit")
    assert nb == 1000 * 32 * 4 + 2 * 1000 * 4 + 3 * 32 * 4 + 6 * 1024 * 32 * 4 + 1024 * 4
    assert TL.leapfrog_bytes(1, 1, 8, "normal_learned") - TL.leapfrog_bytes(1, 1, 8, "bernoulli_logit") == 32


# ---------------------------------------------------------------------------
# K6: logistic regression over the whole X
# ---------------------------------------------------------------------------

def _logreg_inputs(seed=0, c=13, n=300, d=7):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    w = rng.normal(size=(c, d)).astype(np.float32)
    return w, x, y


def test_logreg_plain_matches_pallas_interpret_and_reference():
    w, x, y = _logreg_inputs()
    vp, gp = PLR.logreg_value_and_grad_pallas(*map(jnp.asarray, (w, x, y)), 1.5, interpret=True)
    vr, gr = PLR.logreg_value_and_grad_reference(*map(jnp.asarray, (w, x, y)), 1.5)
    v, g = TLR.logreg_value_and_grad_reference(*map(torch.as_tensor, (w, x, y)), 1.5)
    # f32 sums over 300 rows in two libraries: 1e-5 of the output's scale
    for got, want in ((v, vp), (g, gp), (v, vr), (g, gr)):
        scale = max(float(np.max(np.abs(np.asarray(want)))), 1.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)
    before = TLR.LOGREG.launches
    v2, g2 = TLR.logreg_value_and_grad(*map(torch.as_tensor, (w, x, y)), 1.5)
    assert torch.equal(v, v2) and torch.equal(g, g2) and TLR.LOGREG.launches == before


# ragged shapes: no axis a multiple of 8, and D=1
@pytest.mark.parametrize("c,n,d", [(13, 300, 7), (5, 37, 33), (3, 64, 1)])
def test_logreg_maps_onto_the_bernoulli_glm(c, n, d):
    """K6 runs K1's passes over the Bernoulli FusedFamily that logreg_data
    builds (b = 0, m = 0, iv = 1/sigma^2, ll_scale = 1): that family's plain
    version is K6's function, as the plain version and the JAX Pallas
    kernel (interpret mode) compute it."""
    w, x, y = _logreg_inputs(seed=c, c=c, n=n, d=d)
    data = TLR.logreg_data(torch.as_tensor(x), torch.as_tensor(y), 1.5)
    assert data.family == "bernoulli_logit" and data.ll_scale == 1.0
    assert not bool(data.b.any()) and not bool(data.prior_mean.any())
    assert torch.equal(data.prior_inv_var, torch.full((d,), 1 / 1.5**2))
    v, g = data.plain(torch.as_tensor(w))
    vp, gp = PLR.logreg_value_and_grad_pallas(*map(jnp.asarray, (w, x, y)), 1.5, interpret=True)
    vr, gr = TLR.logreg_value_and_grad_reference(*map(torch.as_tensor, (w, x, y)), 1.5)
    # f32 sums in another order: 1e-5 of the output's scale
    for got, want in ((v, vp), (g, gp), (v, vr), (g, gr)):
        scale = max(float(np.max(np.abs(np.asarray(want)))), 1.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)


def _aligned(t):
    """A contiguous copy of t whose data starts 128 bytes aligned."""
    buf = torch.empty(t.numel() + 32)
    k = (-buf.data_ptr() % 128) // 4
    out = buf[k:k + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def test_logreg_data_is_kept_for_the_same_inputs():
    """logreg_value_and_grad builds K6's data once for a run of calls with
    the same x, y and sigma: an edit of x or y in place, another sigma or
    another tensor rebuilds it."""
    w, x, y = _logreg_inputs(seed=2, n=40, d=32)
    xt, yt = _aligned(torch.as_tensor(x)), torch.as_tensor(y)
    first = TLR._LAST.get(xt, yt, 1.5)
    assert TLR._LAST.get(xt, yt, 1.5) is first
    assert first.x.data_ptr() == xt.data_ptr()  # rows of 128 bytes: X itself, no copy
    xt.mul_(1.0)  # an edit in place
    edited = TLR._LAST.get(xt, yt, 1.5)
    assert edited is not first and TLR._LAST.get(xt, yt, 1.5) is edited
    assert TLR._LAST.get(xt, yt, 2.0) is not edited  # a new sigma
    rebuilt = TLR._LAST.get(xt, yt, 2.0)
    yt.add_(0.0)
    assert TLR._LAST.get(xt, yt, 2.0) is not rebuilt
    assert TLR._LAST.get(xt.clone(), yt, 2.0) is not TLR._LAST.get(xt, yt, 2.0)
    assert torch.equal(TLR._LAST.get(xt, yt, 2.0).prior_inv_var, torch.full((32,), 0.25))


@pytest.mark.parametrize("d", [32, 1024, 7, 33, 1025])
def test_logreg_data_copies_only_a_ragged_x(d):
    """X's rows are 128 bytes apart at D = 32 and 1024, so K6 reads X
    itself; a ragged D takes one padded copy per key."""
    xt = _aligned(torch.randn(3, d))
    data = TLR.logreg_data(xt, torch.zeros(3), 1.0)
    assert G.x_row_aligned(data.x) and torch.equal(data.x, xt)
    assert (data.x.data_ptr() == xt.data_ptr()) == (d * 4 % G.ROW_BYTES == 0)


def test_logreg_log_posterior_autograd_matches_jax_vjp():
    w, x, y = _logreg_inputs(seed=1)
    cot = np.linspace(-1.0, 2.0, w.shape[0]).astype(np.float32)  # a non-unit cotangent
    jlp = PLR.make_logreg_log_posterior(jnp.asarray(x), jnp.asarray(y), 0.8, use_pallas=False)
    jval, vjp = jax.vjp(jlp, jnp.asarray(w))
    (jgrad,) = vjp(jnp.asarray(cot))
    tlp = TLR.make_logreg_log_posterior(x, y, 0.8, device="cpu")
    wt = torch.as_tensor(w).requires_grad_(True)
    val = tlp(wt)
    (grad,) = torch.autograd.grad(val, wt, grad_outputs=torch.as_tensor(cot))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-5)
    # the backward is exactly g[:, None] * (the gradient the forward computed)
    _, g_fwd = TLR.logreg_value_and_grad_reference(*map(torch.as_tensor, (w, x, y)), 0.8)
    assert torch.equal(grad, torch.as_tensor(cot)[:, None] * g_fwd)
    # only "auto": the tensors' device picks the kernel or its plain version
    for other in (True, False, "tpu"):
        with pytest.raises(ValueError, match="use_pallas"):
            TLR.make_logreg_log_posterior(x, y, device="cpu", use_pallas=other)


def test_sample_with_the_logreg_value_and_grad():
    """sample(value_and_grad_fn=<K6's wrapper>), as the JAX scripts call
    it: the recognizer is skipped and the run finishes with finite draws."""
    x, y, _ = make_logreg_data(100, 3, seed=4)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y.astype(np.float32))
    res = sample(t_logreg(x, y), kernel=ChEESHMC(), num_samples=60, num_warmup=60,
                 num_chains=8, key=0, device="cpu",
                 value_and_grad_fn=lambda w: TLR.logreg_value_and_grad(w, xt, yt, 1.0))
    assert res.diagnostics["fused_family"] is None
    assert res.samples["w"].shape == (8, 60, 3) and bool(torch.isfinite(res.samples["w"]).all())
