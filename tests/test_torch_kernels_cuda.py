"""The hand-written CUDA kernels K1-K6 against their plain versions.

These tests need a CUDA card (the kernels have no CPU mode): they are
marked ``cuda`` and skip without one.  The file imports neither JAX nor
brancher_tpu, so it also runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

import brancher_torch.inference.vectorized_nuts as TV
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
# The bf16 kernels (K2, K4) sum their linear predictor on the tensor cores
# in another order than the plain version's cuBLAS product.  Where that
# moves an f32 residual across a bf16 rounding boundary, the kernel's bf16
# residual is another bf16 value (a tie: within G.TIE_UNITS of the
# residual's f32 precision; K2 on an H100 flipped at most 1.7e-5 of its
# residuals).  So their gradient is held to TOL plus the bound of the ties'
# move (0 without ties), and to TOL against the plain formula on the
# kernel's own residual, and every differing residual must be a tie, as in
# chip_smoke.py; the unrounded control must fail that gate.  A Normal
# residual near 0 flips for the same last bits of loc where bf16's step is
# finest, hence K4's larger share (1.77e-4 on an H100 at C=256, N=131072).
FLIP_SHARE = {"bernoulli_logit": 1e-4, "normal_learned": 1e-3}


def _bf16_gate(r, family):
    """The list of the bf16 gate's limits that ``r`` (G.bf16_residual_readings) breaks."""
    return [name for name, held in (
        ("gradient", r["grad_max_rel"] <= TOL + r["flip_allowance_rel"]),
        ("gradient on its residual", r["grad_given_resid_rel"] <= TOL),
        ("ties only", r["flips_legal"]),
        ("tie share", r["flip_share"] <= FLIP_SHARE[family])) if not held]


def _check_bf16_gradient(kernel, z, data, g, g_ref):
    readings = G.bf16_residual_readings(g, kernel.residual(z, data), z, data, g_ref)
    assert _bf16_gate(readings, data.family) == [], readings
    ctl_data = data._replace(x=data.x.float())  # control: z and the residual not rounded
    _, g_ctl = ctl_data.plain(z)
    ctl = G.bf16_residual_readings(g_ctl, G.residual_reference(z, ctl_data), z, data, g_ref)
    assert _bf16_gate(ctl, data.family) != [], ctl


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda")


def _data(family, dtype, c, n, d, device, seed=0, align_x=True):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = ((rng.uniform(size=n) < 0.5) if family == "bernoulli_logit" else rng.normal(size=n)).astype(np.float32)
    b = (0.3 * rng.normal(size=n)).astype(np.float32)
    u = np.zeros(d, np.float32)
    u[-1] = 0.2
    data = G.build_glm_data(family, x, y, b, np.linspace(-1, 1, d), np.linspace(0.5, 2, d),
                            u=u if family == "normal_learned" else None, c0=-0.3,
                            ll_scale=1.7, dtype=dtype, device=device, align_x=align_x)
    z = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32), device=device)
    return data, z


def _close(got, ref, rel):
    err = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
    assert err <= rel, f"relative error {err:.3g} over the limit {rel:.3g}"


def _path(d, dtype):
    return "narrow" if G.takes_narrow_pass(d, dtype) else "two_pass"


def _check_kernel(family, dtype, c, n, d, device):
    data, z = _data(family, dtype, c, n, d, device)
    kernel = G.kernel_for(family, dtype)
    before, on_path = kernel.launches, kernel.path_launches[_path(d, dtype)]
    v, g = kernel(z, data)
    v_ref, g_ref = data.plain(z)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert kernel.path_launches[_path(d, dtype)] == on_path + 1
    _close(v, v_ref, TOL)
    if dtype == "bf16":
        _check_bf16_gradient(kernel, z, data, g, g_ref)
    else:
        _close(g, g_ref, TOL)
    v2, g2 = kernel(z, data)  # no atomics: two runs give identical bits
    assert torch.equal(v, v2) and torch.equal(g, g2)


# ragged shapes: C not a multiple of the chain blocks, N not a multiple of
# the row tiles, D not a multiple of the depth chunks; (100, 1037, 33) has
# no axis a multiple of 8, so K1-K4 read X through padded rows and their
# scratch through padded strides
@pytest.mark.parametrize("family,dtype", FAMILY_DTYPE)
@pytest.mark.parametrize("c,n,d", [(13, 300, 7), (130, 1000, 70), (1, 1, 1), (100, 1037, 33)])
def test_kernel_matches_plain(cuda, family, dtype, c, n, d):
    _check_kernel(family, dtype, c, n, d, cuda)


# K1-K4 at the MXU-scale GLM's width (C=256, D=1024) and K3/K4 at the
# linear-Gaussian regression's (D=1025: z = [sigma, w]), depth cut to N=8192
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family,d", [("bernoulli_logit", 1024), ("normal_learned", 1024),
                                      ("normal_learned", 1025)])
def test_glm_kernel_at_mxu_width(cuda, family, d, dtype):
    _check_kernel(family, dtype, 256, 8192, d, cuda)


def _ar_family(order, length, device):
    """The AR path's family: ar_model over make_ar_data's series, as the
    recognizer extracts it (X the lag matrix with a zero noise column)."""
    from brancher_torch.models import ar_model, make_ar_data

    coeffs = (0.7,) if order == 1 else (0.5, 0.2)
    comp = ar_model(make_ar_data(length, coeffs, 0.3, seed=0), order).compiled(device)
    fam = G.recognize_fused_family(comp, comp.initial_params)
    assert fam is not None and fam.family == "normal_learned"
    gen = torch.Generator(device=device).manual_seed(5)
    z = 0.1 * torch.randn((512, order + 1), generator=gen, device=device)
    z[:, :order] += torch.tensor(coeffs, device=device)
    z[:, -1] += float(np.log(0.3))  # chains near the posterior
    return fam, z


# K3/K4 on the AR paths of chip_smoke.py: AR(1) at T=2000 and AR(2) at
# T=1000, 512 chains, D = order + 1
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("order,length", [(1, 2000), (2, 1000)])
def test_glm_kernel_on_the_ar_paths(cuda, order, length, dtype):
    fam, z = _ar_family(order, length, cuda)
    data = G.build_glm_data(fam.family, fam.x, fam.y, fam.b, fam.prior_mean, fam.prior_inv_var,
                            u=fam.u, c0=fam.c0, ll_scale=fam.ll_scale, dtype=dtype, device=cuda)
    kernel = G.kernel_for(fam.family, dtype)
    v, g = kernel(z, data)
    v_ref, g_ref = data.plain(z)
    torch.cuda.synchronize()
    _close(v, v_ref, TOL)
    if dtype == "bf16":
        _check_bf16_gradient(kernel, z, data, g, g_ref)
    else:
        _close(g, g_ref, TOL)


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
# The f32 narrow pass: K1, K3 and K6 at D <= G.NARROW_MAX_D, one fused pass
# in place of passes A and B, held to the plain version in float64
# ---------------------------------------------------------------------------
def _plain_f64(data, z, block=128):
    """``data.plain`` in float64, by blocks of chains (one block's logits at
    N = 581,012 are 0.6 GB)."""
    d64 = data._replace(scratch=None, **{f: getattr(data, f).double() for f in (
        "x", "y", "b", "prior_mean", "prior_inv_var", "u") if getattr(data, f) is not None})
    parts = [d64.plain(z[i:i + block].double()) for i in range(0, z.shape[0], block)]
    return torch.cat([v for v, _ in parts]), torch.cat([g for _, g in parts])


T = G.NARROW_MAX_D
# the covtype cells' shapes, the ragged and floor shapes, and the widths
# around the threshold on N = 2049 rows (the last row tile holds one live
# row, the rest are masked) and C = 130 (the second chain tile holds two)
NARROW_SHAPES = [(1024, 581012, 55), (64, 581012, 55), (100, 1037, 33), (1024, 1000, 32),
                 (130, 2049, 1), (130, 2049, 2), (130, 2049, 55), (130, 2049, T), (130, 2049, T + 1)]


@pytest.mark.parametrize("c,n,d", NARROW_SHAPES)
@pytest.mark.parametrize("kernel_name", ["glm_bernoulli_f32", "glm_normal_f32", "logreg_f32"])
def test_narrow_pass_matches_float64(cuda, kernel_name, c, n, d):
    kernel = TLR.LOGREG if kernel_name == "logreg_f32" else G.KERNELS[kernel_name]
    data, z = _data(kernel.family, "f32", c, n, d, cuda)
    if kernel is TLR.LOGREG:  # b = 0, a N(0, 1.5^2) prior, ll_scale 1
        data = TLR.logreg_data(data.x.contiguous(), data.y, 1.5)
    path = _path(d, "f32")
    assert G.plan_glm(c, n, d, "f32", 132).narrow == (path == "narrow") == (d <= T)
    before, on_path = kernel.launches, kernel.path_launches[path]
    v, g = kernel(z, data)
    v2, g2 = kernel(z, data)
    v_ref, g_ref = _plain_f64(data, z)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2 and kernel.path_launches[path] == on_path + 2
    _close(v.double(), v_ref, TOL)
    _close(g.double(), g_ref, TOL)
    assert torch.equal(v, v2) and torch.equal(g, g2)  # no atomics: the same bits


@pytest.mark.parametrize("d", [1, 16, 17, 32, 55, 64])
@pytest.mark.parametrize("chain_tile", [64, 128])
def test_narrow_occupancy_holds_the_planners_wave(cuda, chain_tile, d):
    """The runtime fits at least the narrow blocks a multiprocessor that the
    planner counts on (registers and shared memory), so its splits run in
    one wave."""
    import ctypes

    from brancher_torch.ops.cuda_build import load_library

    fn = load_library("glm_vg").glm_sm90_narrow_blocks
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = ctypes.c_int(0)
    assert fn(chain_tile, d, ctypes.addressof(out)) == 0
    assert out.value >= G.NARROW_TILES.blocks_per_sm


# ---------------------------------------------------------------------------
# K5 (csrc/leapfrog.cu) and K6 (the logreg entry of glm_vg.cu, K1's passes)
# ---------------------------------------------------------------------------
# as chip_smoke.py: 8x above the worst trajectory reading on an H100
# (3.6e-6 at 32 steps), below the TF32 control
TOL_LEAPFROG = 3e-5


def _check_leapfrog(family, c, n, d, device, steps, eps=0.05):
    """K5 against its plain version (a loop of the family's plain
    value+grad) for each step count: one launch a trajectory, within
    TOL_LEAPFROG, the same bits on a second launch."""
    data, z = _data(family, "f32", c, n, d, device, align_x=False)  # K5 reads X contiguous
    lf = TL.FusedLeapfrog(data)
    gen = torch.Generator(device=device).manual_seed(1)
    r = torch.randn((c, d), generator=gen, device=device)
    _, g = data.plain(z)
    im = torch.linspace(0.5, 1.5, d, device=device)
    eps = torch.tensor(eps, device=device)
    for n_steps in steps:
        before = TL.LEAPFROG.launches
        out = lf(z, r, g, eps, im, torch.tensor(n_steps, device=device))
        ref = TL.reference_leapfrog(data.plain)(z, r, g, eps, im, n_steps)
        torch.cuda.synchronize()
        assert TL.LEAPFROG.launches == before + 1
        for got, want in zip(out, ref):
            _close(got, want, TOL_LEAPFROG)
        again = lf(z, r, g, eps, im, n_steps)
        assert all(torch.equal(a, b) for a, b in zip(out, again))


# ragged shapes: C not a multiple of the chains per block, N not a multiple
# of the rows a tile or a slice takes, D not a multiple of 4 or of 32
@pytest.mark.parametrize("family", ["bernoulli_logit", "normal_learned"])
@pytest.mark.parametrize("c,n,d", [(13, 300, 7), (130, 700, 70), (1, 1, 1)])
def test_leapfrog_matches_plain(cuda, family, c, n, d):
    _check_leapfrog(family, c, n, d, cuda, (0, 1, 5))


# the floor shape (eight chains and sixteen warps a block, one tile).  The
# step is 0.03: at 0.05 some Normal chains of these inputs lie near the
# edge of stability, and after 32 steps the plain loop in f32 is itself
# 1e-4 from the same loop in f64 (2.2e-6 at 0.03; on the CPU), so no f32
# kernel could be held to TOL_LEAPFROG there
@pytest.mark.parametrize("n_steps", [1, 8, 32])
@pytest.mark.parametrize("family", ["bernoulli_logit", "normal_learned"])
def test_leapfrog_at_the_floor_shape(cuda, family, n_steps):
    _check_leapfrog(family, 1024, 1000, 32, cuda, (n_steps,), eps=0.03)


# the planner's other corners: near the size gate (one warp, many tiles;
# at N=1757 r and g in the outputs), fewer chains than multiprocessors,
# D over three 32-column chunks with two chains a block, one chain
@pytest.mark.parametrize("family", ["bernoulli_logit", "normal_learned"])
@pytest.mark.parametrize("c,n,d", [(256, 1750, 32), (256, 1757, 32), (13, 1000, 32),
                                   (256, 700, 70), (1, 300, 7)])
def test_leapfrog_at_the_plan_edges(cuda, family, c, n, d):
    _check_leapfrog(family, c, n, d, cuda, (1, 6))


# K5 on the AR(1) ChEES path (D = 2, the whole lag matrix in each block)
@pytest.mark.parametrize("order,length", [(1, 2000), (2, 1000)])
def test_leapfrog_on_the_ar_paths(cuda, order, length):
    fam, z = _ar_family(order, length, cuda)
    lf = fam.leapfrog()
    assert isinstance(lf, TL.FusedLeapfrog)
    data = lf.data
    gen = torch.Generator(device=cuda).manual_seed(6)
    r = torch.randn(z.shape, generator=gen, device=cuda)
    _, g = data.plain(z)
    im = torch.full((order + 1,), 1e-3, device=cuda)  # the posterior's scale
    eps = torch.tensor(0.3, device=cuda)
    for n_steps in (1, 4, 16):
        before = TL.LEAPFROG.launches
        out = lf(z, r, g, eps, im, torch.tensor(n_steps, device=cuda))
        ref = TL.reference_leapfrog(data.plain)(z, r, g, eps, im, n_steps)
        torch.cuda.synchronize()
        assert TL.LEAPFROG.launches == before + 1
        for got, want in zip(out, ref):
            _close(got, want, TOL_LEAPFROG)


def test_leapfrog_propagates_non_finite_positions(cuda):
    data, z = _data("bernoulli_logit", "f32", 8, 50, 4, cuda, align_x=False)
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


# K6 at the MXU-scale shape (X itself, rows 4 KB apart) and at a ragged D
# (one padded copy of X, kept while x, y and sigma stay the same)
@pytest.mark.parametrize("d", [1024, 1025])
def test_logreg_at_the_mxu_shape(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(4)
    n, c = 131072, 256
    x = torch.randn((n, d), generator=gen, device=cuda) / d**0.5
    y = (torch.rand((n,), generator=gen, device=cuda) < 0.5).float()
    w = torch.randn((c, d), generator=gen, device=cuda)
    before = TLR.LOGREG.launches
    v, g = TLR.logreg_value_and_grad(w, x, y, 1.5)
    torch.cuda.synchronize()
    assert TLR.LOGREG.launches == before + 1
    data = TLR._LAST.data
    assert (data.x.data_ptr() == x.data_ptr()) == (d == 1024)
    v_ref, g_ref = TLR.logreg_value_and_grad_reference(w, x, y, 1.5)
    _close(v, v_ref, TOL)
    _close(g, g_ref, TOL)
    v2, g2 = TLR.logreg_value_and_grad(w, x, y, 1.5)
    assert TLR._LAST.data is data and TLR.LOGREG.launches == before + 2
    assert torch.equal(v, v2) and torch.equal(g, g2)


def _floor_family(device):
    """The floor's family (chip_smoke.py phase 3): make_logreg_data(1000, 32)."""
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    x, y, _ = make_logreg_data(1000, 32, seed=0)
    comp = logistic_regression_model(x, y).compiled(device)
    fam = G.recognize_fused_family(comp, comp.initial_params)
    assert fam is not None and fam.family == "bernoulli_logit"
    z = 0.3 * torch.randn((1024, 32), generator=torch.Generator(device=device).manual_seed(6),
                          device=device)
    return fam, z


# mass="dense": stage B runs the value+grad kernel inside the whitened
# wrapper (v, g @ L) at mu + zt @ L.T; K3 on AR(2), K1 at the floor, each
# against the same wrapper around its plain version
@pytest.mark.parametrize("path", ["ar2", "floor"])
def test_whitened_wrapper_around_the_kernel(cuda, path):
    from brancher_torch.inference.mcmc import dense_statistics, whiten, whitened

    fam, z = _ar_family(2, 1000, cuda) if path == "ar2" else _floor_family(cuda)
    c, d = z.shape
    gen = torch.Generator(device=cuda).manual_seed(7)
    mix = torch.eye(d, device=cuda) + 0.4 * torch.randn((d, d), generator=gen, device=cuda) / d**0.5
    zs_a = z[:, None, :] + 0.02 * torch.randn((c, 4, d), generator=gen, device=cuda) @ mix.T
    mu, _, chol = dense_statistics(zs_a)
    zt = whitened(z, mu, chol)
    kernel = G.kernel_for(fam.family, "f32")
    before = kernel.launches
    v, g = whiten(fam.value_and_grad("f32"), mu, chol)(zt)
    v_ref, g_ref = whiten(fam.plain, mu, chol)(zt)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _close(v, v_ref, TOL)
    _close(g, g_ref, TOL)


# NUTS(pipelined=True): the value+grad kernel runs once an iteration, and
# the counted calls are the launches
def test_pipelined_run_launches_once_a_call(cuda):
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.models import ar_model, make_ar_data

    model = ar_model(make_ar_data(1000, (0.5, 0.2), 0.3, seed=0), 2)
    kernel = G.kernel_for("normal_learned", "f32")
    before = kernel.launches
    res = sample(model, kernel=NUTS(max_depth=6, pipelined=True), num_warmup=60, num_samples=40,
                 num_chains=64, key=0, device="cuda")
    d = res.diagnostics
    assert d["fused_family"] == "normal_learned"
    assert kernel.launches - before == d["value_and_grad_calls"] > 0
    assert bool(torch.isfinite(res.samples["coeffs"]).all())


# a resumed pipelined call starts on the kernel from the last call's draws,
# which the resume state holds as contiguous rows
def test_a_resumed_pipelined_run_runs_on_the_kernel(cuda):
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    x, y, _ = make_logreg_data(1000, 32, seed=0)
    model = logistic_regression_model(x, y)
    kw = dict(kernel=NUTS(max_depth=6, pipelined=True), num_chains=64, device="cuda")
    first = sample(model, num_warmup=40, num_samples=10, key=0, **kw)
    state = first.diagnostics["resume_state"]
    assert state["z"].is_contiguous()
    kernel = G.kernel_for("bernoulli_logit", "f32")
    before = kernel.launches
    res = sample(model, num_warmup=0, num_samples=10, key=1, resume_state=state, **kw)
    assert res.diagnostics["fused_family"] == "bernoulli_logit"
    assert kernel.launches - before == res.diagnostics["value_and_grad_calls"] > 0
    assert bool(torch.isfinite(res.samples["w"]).all())


# The autodiff value+grad of sample()'s autodiff paths (no kernel of the
# port's) replays a CUDA graph on the card: the eager call's numbers at
# every replay, new inputs copied in; a function that waits on the card
# cannot be captured and runs eagerly at that shape
def _eight_schools():
    import brancher_torch as BT

    mu, tau = BT.NormalVariable(0.0, 5.0, "mu"), BT.HalfCauchyVariable(5.0, "tau")
    raw = BT.NormalVariable(np.zeros(8, np.float32), np.ones(8, np.float32), "theta_raw")
    y = BT.NormalVariable(BT.DeterministicVariable(mu + tau * raw, "theta"),
                          np.float32([15, 10, 16, 11, 9, 11, 10, 18]), "y")
    y.observe(np.float32([28, 8, -3, 7, -1, 1, 18, 12]))
    return BT.ProbabilisticModel([y])


def _gp():
    import brancher_torch as BT
    from brancher_torch.stochastic_processes import GaussianProcess

    xs = np.linspace(0, 2, 15).astype(np.float32)
    f = GaussianProcess(xs, lengthscale=0.5, variance=1.0, name="f")
    y = BT.NormalVariable(f, 0.1, "y")
    y.observe(np.sin(2 * xs).astype(np.float32))
    return BT.ProbabilisticModel([y])


@pytest.mark.parametrize("make_model", [_eight_schools, _gp], ids=["eight_schools", "gp"])
def test_graphed_autodiff_matches_eager(cuda, make_model):
    from brancher_torch.inference.hmc import autodiff_value_and_grad
    from brancher_torch.inference.mcmc import make_potential

    comp = make_model().compiled(cuda)
    pot, _, _ = make_potential(comp, comp.initial_params)
    graphed = autodiff_value_and_grad(pot)
    eager = graphed.fn
    gen = torch.Generator(device=cuda).manual_seed(0)
    for _ in range(4):
        z = torch.randn((16, comp.dim), generator=gen, device=cuda)
        v, g = graphed(z)
        v_ref, g_ref = eager(z)
        torch.testing.assert_close(v, v_ref, rtol=0, atol=0)
        torch.testing.assert_close(g, g_ref, rtol=0, atol=0)
    assert len(graphed.graphs) + len(graphed.eager_shapes) == 1


def _sequence_hmm(t_len=60, k=2):
    """A MarkovProcess HMM (the sequence-node enumeration path), its
    transition logits a link so that they follow the model to the card."""
    import brancher_torch as BT
    import brancher_torch.functions as BF
    from brancher_torch.distributions import Categorical
    from brancher_torch.stochastic_processes import MarkovProcess

    s = MarkovProcess(t_len, Categorical(), lambda prev, lt: {"logits": lt[prev]},
                      links={"lt": np.float32([[2.0, -2.0], [-2.0, 2.0]])},
                      init_dist=Categorical(), init_links={"logits": np.zeros(k, np.float32)},
                      name="s")
    locs = BT.NormalVariable(np.zeros(k, np.float32), 2.0 * np.ones(k, np.float32), "locs")
    y = BT.NormalVariable(BF.take(locs, s), 0.5, "y")
    y.observe(np.random.RandomState(3).normal(0, 1.5, t_len).astype(np.float32))
    return BT.ProbabilisticModel([y])


def test_graphed_enumerated_value_and_grad_matches_eager(cuda):
    """The enumerated potential (forward algorithm over T inside the
    value+grad) is captured, not run eagerly, and its replays equal the
    eager call bit for bit."""
    from brancher_torch.inference.hmc import autodiff_value_and_grad
    from brancher_torch.inference.mcmc import make_enum_potential

    comp = _sequence_hmm().compiled(cuda)
    pot = make_enum_potential(comp, comp.initial_params, None, comp.unravel_z)
    graphed = autodiff_value_and_grad(pot)
    eager = graphed.fn
    gen = torch.Generator(device=cuda).manual_seed(0)
    for _ in range(4):
        z = torch.randn((16, comp.dim), generator=gen, device=cuda)
        v, g = graphed(z)
        v_ref, g_ref = eager(z)
        torch.testing.assert_close(v, v_ref, rtol=0, atol=0)
        torch.testing.assert_close(g, g_ref, rtol=0, atol=0)
    assert len(graphed.graphs) == 1 and not graphed.eager_shapes


def test_sample_twice_replays_the_first_calls_graphs(cuda):
    """A second ``sample()`` on the same model and data takes the graphed
    value+grad of the first from the compiled model: it captures no graph
    (0 new graphs, 0 s) and gives the first call's bits."""
    from brancher_torch.inference import NUTS, sample

    model = _sequence_hmm()
    kw = dict(kernel=NUTS(max_depth=5), num_samples=20, num_warmup=20, num_chains=16, key=0,
              device=cuda, enumerate_discrete=True)
    r1 = sample(model, **kw)
    r2 = sample(model, **kw)
    d1, d2 = r1.diagnostics, r2.diagnostics
    assert d1["value_and_grad_graphed"] and d2["value_and_grad_graphed"]
    assert d1["value_and_grad_captures"] >= 1 and d1["value_and_grad_capture_seconds"] > 0
    assert d2["value_and_grad_captures"] == 0 and d2["value_and_grad_capture_seconds"] == 0
    for name in r1.samples:
        assert torch.equal(r1.samples[name], r2.samples[name])
    assert torch.equal(r1.stats["accept_prob"], r2.stats["accept_prob"])


def test_a_value_and_grad_that_waits_on_the_card_runs_eagerly(cuda):
    from brancher_torch.inference.hmc import GraphedValueAndGrad

    def waits(z):
        s = float(z.sum())  # a read back: no capture
        return z.sum(-1) * 0 + s, z * 2

    graphed = GraphedValueAndGrad(waits)
    z = torch.ones((4, 3), device=cuda)
    v, g = graphed(z)
    assert graphed.eager_shapes and not graphed.graphs
    torch.testing.assert_close(v, torch.full((4,), 12.0, device=cuda))
    torch.testing.assert_close(g, z * 2)


def test_cuda_generator_survives_a_checkpoint(cuda, tmp_path):
    """A CUDA generator goes through save_checkpoint as its state and
    device and comes back on the card, drawing on where it stopped."""
    from brancher_torch.checkpoint import restore_checkpoint, save_checkpoint

    g = torch.Generator(device=cuda).manual_seed(5)
    torch.rand(1000, generator=g, device=cuda)
    save_checkpoint(str(tmp_path), {"g": g, "z": torch.ones(3, device=cuda)})
    r = restore_checkpoint(str(tmp_path))
    assert r["g"].device.type == "cuda" and r["z"].device.type == "cuda"
    assert torch.equal(torch.rand(64, generator=r["g"], device=cuda),
                       torch.rand(64, generator=g, device=cuda))


def test_streaming_resume_is_bit_identical_on_the_card(cuda, tmp_path):
    from brancher_torch.checkpoint import restore_checkpoint, save_checkpoint
    from brancher_torch.inference.streaming_smc import StreamingSMC
    from brancher_torch.models import lgssm_state_space, make_lgssm_data

    _, ys = make_lgssm_data(length=120, seed=5)
    ys = np.asarray(ys)
    kw = dict(num_particles=512, lag=8, device=cuda)
    f = StreamingSMC(lgssm_state_space(), **kw)
    state, _ = f.init(ys[0], key=0)
    state, _ = f.process(state, ys[1:60])
    save_checkpoint(str(tmp_path), state)
    state, (m, sm, _, _) = f.process(state, ys[60:])
    state2 = restore_checkpoint(str(tmp_path))
    state2, (m2, sm2, _, _) = StreamingSMC(lgssm_state_space(), **kw).process(state2, ys[60:])
    assert torch.equal(m, m2) and torch.equal(sm, sm2) and state.t == state2.t
    for a, b in zip(state[1:5], state2[1:5]):
        assert torch.equal(a, b)


def test_a_model_saved_on_the_cpu_loads_onto_the_card(cuda, tmp_path):
    import brancher_torch as BT
    from brancher_torch.serialization import load_model, save_model

    mu = BT.NormalVariable(0.0, 2.0, "mu")
    sigma = BT.LogNormalVariable(0.0, 0.5, "sigma")
    x = BT.NormalVariable(mu, sigma, "x", plate_shape=(20,))
    x.observe(np.random.RandomState(0).randn(20).astype(np.float32))
    model = BT.ProbabilisticModel([x])
    vals = {"mu": np.asarray([0.5, -1.0], np.float32), "sigma": np.asarray([1.0, 0.3], np.float32)}
    lp = model.calculate_log_probability(vals, device="cpu")
    save_model(model, str(tmp_path / "m.pkl"))
    loaded = load_model(str(tmp_path / "m.pkl"), device="cuda")
    assert loaded.get_variable("x").observed_value.device.type == "cuda"
    lp_card = loaded.calculate_log_probability(vals, device="cuda")
    assert lp_card.device.type == "cuda"
    torch.testing.assert_close(lp_card.cpu(), lp, rtol=1e-6, atol=0)
    # and back: a model holding card tensors loads onto the CPU
    save_model(loaded, str(tmp_path / "m2.pkl"))
    back = load_model(str(tmp_path / "m2.pkl"), device="cpu")
    assert back.get_variable("x").observed_value.device.type == "cpu"
    torch.testing.assert_close(back.calculate_log_probability(vals, device="cpu"), lp, rtol=0, atol=0)


# The lockstep NUTS tree on the card (inference/vectorized_nuts.py): after
# its first transition at a shape, the start and every leaf replay CUDA
# graphs.  Replayed, a tree must take the leaves and give the bits of the
# same tree run eagerly from the same generator state (a random source of
# another type than TorchNutsRandom runs it eagerly); a later sample() call
# captures nothing and replays every leaf; a value+grad the card cannot
# capture runs every leaf eagerly, on the caller's stream of numbers.
class _EagerRandom:
    """TorchNutsRandom's draws from the same generator, under another type."""

    def __init__(self, generator):
        self.generator = generator
        self._rng = TV.TorchNutsRandom(generator)

    def momentum(self, z):
        return self._rng.momentum(z)

    def leaf(self, n, c, like):
        return self._rng.leaf(n, c, like)


@pytest.fixture(scope="module")
def covtype_k1():
    """K1's value+grad at UCI Covertype's shape (N 581012, D 55)."""
    from brancher_torch.models import make_logreg_data

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 runs only there")
    x, y, _ = make_logreg_data(581_012, 55, seed=3)
    d = x.shape[1]
    return G.build_glm_vg("bernoulli_logit", x, y, np.zeros(len(y), np.float32),
                          np.zeros(d, np.float32), np.ones(d, np.float32), device="cuda")


def _ard_value_and_grad():
    """The graphed autodiff value+grad of the sparse ARD logistic regression
    at German Credit's shape (N 1000, D 25; 51 latents)."""
    import brancher_torch as BT
    import brancher_torch.functions as BF
    from brancher_torch.inference.hmc import autodiff_value_and_grad
    from brancher_torch.inference.mcmc import make_potential

    n, d = 1000, 25
    g = torch.Generator().manual_seed(1000)
    w = torch.zeros(d)
    w[torch.randperm(d, generator=g)[:5]] = torch.randn(5, generator=g)
    x = torch.randn(n, d, generator=g)
    x[:, 0] = 1.0
    y = (torch.rand(n, generator=g) < torch.sigmoid(x @ w)).to(torch.int32)
    glob = BT.GammaVariable(0.5, 0.5, "global_scale")
    local = BT.GammaVariable(0.5 * torch.ones(d), 0.5 * torch.ones(d), "local_scales")
    unscaled = BT.NormalVariable(torch.zeros(d), torch.ones(d), "unscaled_weights")
    yv = BT.BernoulliVariable(logits=BF.matmul(x, unscaled * local * glob), name="y")
    yv.observe(y)
    comp = BT.ProbabilisticModel([yv]).compiled("cuda")
    pot, _, _ = make_potential(comp, comp.initial_params)
    return autodiff_value_and_grad(pot), comp.dim


def _graphed_and_eager(vg, z0, **kw):
    """``nuts_batched`` from z0 at generator seed 0 with the recorder on,
    graphed and then eagerly: [(result, counters, capture spans)] each."""
    from brancher_torch import metrics

    runs = []
    for random in (TV.TorchNutsRandom, _EagerRandom):
        gen = torch.Generator(device=z0.device).manual_seed(0)
        with metrics.tracing() as tr:
            res = TV.nuts_batched(vg, z0, generator=gen, rng=random(gen), **kw)
        runs.append((res, tr.counters[0], [s for s in tr.spans if s.name == "nuts.leaf_capture"]))
    return runs


@pytest.mark.parametrize("target", ["k1_covtype", "ard_autodiff", "dense_k1"])
def test_graphed_lockstep_tree_matches_eager(cuda, covtype_k1, target):
    from brancher_torch.inference.mcmc import whiten

    gen = torch.Generator(device=cuda).manual_seed(1)
    if target == "ard_autodiff":
        vg, d = _ard_value_and_grad()
        z0, eps = torch.rand((128, d), generator=gen, device=cuda) * 4.0 - 2.0, 0.05
    else:
        d = 55
        z0, eps, vg = 0.01 * torch.randn((64, d), generator=gen, device=cuda), 0.002, covtype_k1
        if target == "dense_k1":
            # the whitened value+grad of mass="dense": z = mu + zt @ L.T
            lower = torch.tril(torch.randn((d, d), generator=gen, device=cuda), -1)
            vg, eps = whiten(covtype_k1, 0.01 * z0[0], 0.002 * (torch.eye(d, device=cuda) + 0.1 * lower)), 0.5
            z0 = z0 / 0.002
    (graphed, c_g, captures), (eager, c_e, none) = _graphed_and_eager(
        vg, z0, num_warmup=10, num_samples=20, max_depth=8, init_step_size=eps)
    assert len(captures) == 1 and not none
    assert graphed.warmup_leapfrog == eager.warmup_leapfrog
    assert torch.equal(graphed.num_leapfrog, eager.num_leapfrog)
    assert torch.equal(graphed.samples, eager.samples)
    assert torch.equal(graphed.accept_prob, eager.accept_prob)
    assert torch.equal(graphed.step_size, eager.step_size)
    # every leaf after the first transition replayed: value+grad calls that
    # the function did not see, counted by the engine
    leaves = graphed.warmup_leapfrog + int(graphed.num_leapfrog.sum())
    assert c_g["nuts.leaves"] == leaves == c_e["nuts.leaves"]
    assert c_g["nuts.graph_leaves"] == graphed.graph_leaves > 0
    assert c_g["nuts.graph_leaves"] + c_g["nuts.eager_leaves"] == leaves
    assert c_e["nuts.eager_leaves"] == leaves and eager.graph_leaves == 0


@pytest.mark.parametrize("potential", ["auto", "off"], ids=["k1", "autodiff"])
def test_second_sample_call_replays_every_lockstep_leaf(cuda, potential):
    """The trees live with sample()'s cached value+grad: a second call
    captures nothing and replays every leaf, and K1's launches and the
    value+grad calls count the replays."""
    from brancher_torch import metrics
    from brancher_torch.inference import NUTS, sample
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    x, y, _ = make_logreg_data(20_000, 55, seed=3)
    model = logistic_regression_model(x, y)
    kw = dict(kernel=NUTS(max_depth=8), num_chains=64, device="cuda",
              diagnostics_backend="none", fused_potential=potential)
    kernel = G.kernel_for("bernoulli_logit", "f32")
    with metrics.tracing() as tr:
        first = sample(model, num_warmup=10, num_samples=5, key=1, **kw)
        before = kernel.launches
        second = sample(model, num_warmup=0, num_samples=5, key=2,
                        resume_state=first.diagnostics["resume_state"], **kw)
    d = second.diagnostics
    assert (d["fused_family"] == "bernoulli_logit") == (potential == "auto")
    assert [s.call for s in tr.spans if s.name == "nuts.leaf_capture"] == [1]
    c1, c2 = tr.counters[1], tr.counters[2]
    assert c1["nuts.graph_leaves"] + c1["nuts.eager_leaves"] == c1["nuts.leaves"]
    assert c2["nuts.graph_leaves"] == c2["nuts.leaves"] > 0 and c2["nuts.eager_leaves"] == 0
    # one call a leaf, replayed or not, and the engine's first at z0
    assert d["value_and_grad_calls"] == c2["nuts.leaves"] + 1
    if potential == "auto":
        assert kernel.launches - before == d["value_and_grad_calls"]


def test_a_tree_whose_value_and_grad_waits_on_the_card_runs_eagerly(cuda):
    def waits(z):
        s = float(z.sum())  # a read back: no capture
        return -0.5 * (z * z).sum(-1) + 0.0 * s, -z

    z0 = torch.randn((16, 3), generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    (tried, counters, captures), (eager, _, _) = _graphed_and_eager(
        waits, z0, num_warmup=5, num_samples=10, max_depth=6)
    assert len(captures) == 1  # tried once, failed, and not again
    assert counters["nuts.graph_leaves"] == 0 == tried.graph_leaves
    assert counters["nuts.eager_leaves"] == counters["nuts.leaves"] > 0
    # the failed capture drew nothing from the caller's generator
    assert torch.equal(tried.samples, eager.samples)
