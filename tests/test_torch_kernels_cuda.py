"""The hand-written CUDA kernels K1-K6 against their plain versions.

These tests need a CUDA card (the kernels have no CPU mode): they are
marked ``cuda`` and skip without one.  The file imports neither JAX nor
brancher_tpu, so it also runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

import brancher_torch.ops.glm as G
import brancher_torch.ops.leapfrog as TL
import brancher_torch.ops.logreg as TLR

pytestmark = pytest.mark.cuda

FAMILY_DTYPE = [(f, d) for f in ("bernoulli_logit", "normal_learned") for d in ("f32", "bf16")]
# Limit on max|kernel - plain| / max(max|plain|, 1), as in chip_smoke.py:
# only the summation order differs from the plain version (worst reading
# on an H100 9.4e-7, PERF.md), and the product of two bf16 values is exact
# in f32, so the bf16 kernels are held as tightly.  TF32 products, or a
# bf16 kernel that skipped the rounding of z or the residual, exceed it.
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda")


def _data(family, dtype, c, n, d, device, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = ((rng.uniform(size=n) < 0.5) if family == "bernoulli_logit" else rng.normal(size=n)).astype(np.float32)
    b = (0.3 * rng.normal(size=n)).astype(np.float32)
    u = np.zeros(d, np.float32)
    u[-1] = 0.2
    data = G.build_glm_data(family, x, y, b, np.linspace(-1, 1, d), np.linspace(0.5, 2, d),
                            u=u if family == "normal_learned" else None, c0=-0.3,
                            ll_scale=1.7, dtype=dtype, device=device)
    z = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32), device=device)
    return data, z


def _close(got, ref, rel):
    err = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
    assert err <= rel, f"relative error {err:.3g} over the limit {rel:.3g}"


# ragged shapes: C not a multiple of the 64-chain block, N not a multiple
# of the 64-row tile, D not a multiple of the 16/64-wide chunks
@pytest.mark.parametrize("family,dtype", FAMILY_DTYPE)
@pytest.mark.parametrize("c,n,d", [(13, 300, 7), (130, 1000, 70), (1, 1, 1)])
def test_kernel_matches_plain(cuda, family, dtype, c, n, d):
    data, z = _data(family, dtype, c, n, d, cuda)
    kernel = G.kernel_for(family, dtype)
    before = kernel.launches
    v, g = kernel(z, data)
    v_ref, g_ref = data.plain(z)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _close(v, v_ref, TOL)
    _close(g, g_ref, TOL)
    v2, g2 = kernel(z, data)  # no atomics: two runs give identical bits
    assert torch.equal(v, v2) and torch.equal(g, g2)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    data, z = _data("bernoulli_logit", "f32", 8, 50, 4, cuda)
    kernel = G.kernel_for("bernoulli_logit", "f32")
    with pytest.raises(TypeError):
        kernel(z.double(), data)
    with pytest.raises(TypeError):
        kernel(torch.zeros((4, 8), device=cuda).T, data)  # not contiguous
    with pytest.raises(ValueError):
        kernel(torch.zeros((8, 5), device=cuda), data)  # wrong D
    with pytest.raises(TypeError):
        G.kernel_for("bernoulli_logit", "bf16")(z, data)  # x is f32
    with pytest.raises(ValueError):
        G.kernel_for("normal_learned", "f32")(z, data)  # wrong family


# ---------------------------------------------------------------------------
# K5 (csrc/leapfrog.cu) and K6 (the logreg instantiation of glm_vg.cu)
# ---------------------------------------------------------------------------
# as chip_smoke.py: 10x above the worst trajectory reading on an H100
# (3.1e-6 at 32 steps), below the TF32 control
TOL_LEAPFROG = 3e-5


# ragged shapes: C not a multiple of the warps per block, N not a multiple
# of the 32-row tile, D not a multiple of the 32 lanes
@pytest.mark.parametrize("family", ["bernoulli_logit", "normal_learned"])
@pytest.mark.parametrize("c,n,d", [(13, 300, 7), (130, 700, 70), (1, 1, 1)])
def test_leapfrog_matches_plain(cuda, family, c, n, d):
    data, z = _data(family, "f32", c, n, d, cuda)
    lf = TL.FusedLeapfrog(data)
    gen = torch.Generator(device=cuda).manual_seed(1)
    r = torch.randn((c, d), generator=gen, device=cuda)
    _, g = data.plain(z)
    im = torch.linspace(0.5, 1.5, d, device=cuda)
    eps = torch.tensor(0.05, device=cuda)
    for n_steps in (0, 1, 5):
        before = TL.LEAPFROG.launches
        out = lf(z, r, g, eps, im, torch.tensor(n_steps, device=cuda))
        ref = TL.reference_leapfrog(data.plain)(z, r, g, eps, im, n_steps)
        torch.cuda.synchronize()
        assert TL.LEAPFROG.launches == before + 1
        for got, want in zip(out, ref):
            _close(got, want, TOL_LEAPFROG)
        again = lf(z, r, g, eps, im, n_steps)
        assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_leapfrog_propagates_non_finite_positions(cuda):
    data, z = _data("bernoulli_logit", "f32", 8, 50, 4, cuda)
    z[3, 1] = float("inf")
    _, g = data.plain(z)
    z1, r1, v1, g1 = TL.FusedLeapfrog(data)(z, torch.ones_like(z), g, 0.1,
                                            torch.ones(4, device=cuda), 2)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(z1[3]).all()) and not bool(torch.isfinite(v1[3]))
    assert bool(torch.isfinite(z1[:3]).all()) and bool(torch.isfinite(v1[4:]).all())


@pytest.mark.parametrize("c,n,d", [(13, 300, 7), (130, 1000, 70), (1, 1, 1)])
def test_logreg_matches_plain(cuda, c, n, d):
    rng = np.random.RandomState(3)
    x = torch.as_tensor((rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32), device=cuda)
    y = torch.as_tensor((rng.uniform(size=n) < 0.5).astype(np.float32), device=cuda)
    w = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32), device=cuda)
    before = TLR.LOGREG.launches
    v, g = TLR.logreg_value_and_grad(w, x, y, 1.5)
    v_ref, g_ref = TLR.logreg_value_and_grad_reference(w, x, y, 1.5)
    torch.cuda.synchronize()
    assert TLR.LOGREG.launches == before + 1
    _close(v, v_ref, TOL)
    _close(g, g_ref, TOL)
    v2, g2 = TLR.logreg_value_and_grad(w, x, y, 1.5)
    assert torch.equal(v, v2) and torch.equal(g, g2)
    # the autograd form costs one launch for value and gradient
    wt = w.clone().requires_grad_(True)
    val = TLR.make_logreg_log_posterior(x, y, 1.5)(wt)
    (grad,) = torch.autograd.grad(val.sum(), wt)
    assert TLR.LOGREG.launches == before + 3
    assert torch.equal(grad, g)
