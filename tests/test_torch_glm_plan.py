"""The K1-K4 pass planner, X's row layout, the bf16 tie readings, the K5
planner and the kernel build's digest.

K1-K4 (``brancher_torch/csrc/glm_sm90.cuh``) run only on a card; what
surrounds them is plain Python and is held here: the planner
(``ops/glm.py::plan_glm``) must give the kernel the strides, alignment,
row tiles and row splits it checks, the data build must lay X's rows 16
bytes apart for both families, the readings that gate the bf16 kernels
(K2, K4) must tell ties from a missing rounding, and the build digest must
follow every header a kernel source includes and the link flags.
"""
import numpy as np
import pytest
import torch

import brancher_torch.ops.glm as G
import brancher_torch.ops.leapfrog as TL
from brancher_torch.ops import cuda_build

torch.set_num_threads(2)

# (C, N, D): the floor, conjugate and MXU-scale shapes of chip_smoke.py,
# and its ragged one (no axis a multiple of 8)
SHAPES = {
    "floor": (1024, 1000, 32),
    "conjugate": (64, 20, 1),
    "mxu": (256, 131072, 1024),
    "ragged": (100, 1037, 33),
    # the AR(1) and AR(2) paths: X is the lag matrix with a zero column
    # for the noise coordinate, D = order + 1
    "ar1": (512, 1999, 2),
    "ar2": (512, 998, 3),
    # the benchmark's covtype cells: UCI Covertype's shape at 1024 and 64 chains
    "covtype_c1024": (1024, 581012, 55),
    "covtype_c64": (64, 581012, 55),
}
ITEMSIZE = {"f32": 4, "bf16": 2}


def _check_rows_covered(plan, n, step):
    """The splits take rows [s rows_per_split, min((s + 1) rows_per_split, N)):
    contiguous, every row once, none empty, each whole ``step``s."""
    rows = [(s * plan.rows_per_split, min((s + 1) * plan.rows_per_split, n))
            for s in range(plan.splits)]
    assert len(rows) == plan.splits >= 1
    assert rows[0][0] == 0 and rows[-1][1] == n
    for (a, b), (a2, _) in zip(rows, rows[1:]):
        assert b == a2  # contiguous, no overlap
    assert all(b > a for a, b in rows)  # no split is empty
    assert plan.rows_per_split % step == 0


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_covers_every_row_once(shape, dtype, sms):
    c, n, d = SHAPES[shape]
    plan = G.plan_glm(c, n, d, dtype, sms)
    assert plan.narrow == G.takes_narrow_pass(d, dtype)
    if plan.narrow:
        t = G.NARROW_TILES
        _check_rows_covered(plan, n, t.rows)  # splits are whole row tiles
        assert plan.row_tiles == plan.splits  # one log-lik partial per split
        blocks = -(-c // plan.chain_tile)
        assert plan.splits == 1 or blocks * plan.splits <= t.blocks_per_sm * sms
        return
    t = G.GLM_TILES[dtype]
    _check_rows_covered(plan, n, t.rows_b)  # pass B's splits are whole depth steps
    # pass A: one tile per rows_a rows, the last one not empty
    assert (plan.row_tiles - 1) * t.rows_a < n <= plan.row_tiles * t.rows_a
    # pass B runs in one wave, or has one split
    blocks = -(-c // t.chains_b) * -(-d // t.cols_b)
    assert plan.splits == 1 or blocks * plan.splits <= t.blocks_per_sm * sms


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_scratch_layout(shape, dtype):
    c, n, d = SHAPES[shape]
    plan = G.plan_glm(c, n, d, dtype, 132)
    itemsize = ITEMSIZE[dtype]
    shapes = plan.scratch_shapes(c)
    # f32 gradient partials: rows a multiple of 4 floats (float4 / float2 stores)
    assert plan.ldg >= d and plan.ldg % 4 == 0 and plan.ldg - d < 4
    if plan.narrow:  # no staged z, no [C, N] residual
        assert shapes == {"ll_part": (c, plan.splits), "g_part": (plan.splits, c, plan.ldg)}
        assert plan.ldz == plan.ldr == 0
        return
    assert shapes == {"z": (c, plan.ldz), "resid": (c, plan.ldr),
                      "ll_part": (c, plan.row_tiles), "g_part": (plan.splits, c, plan.ldg)}
    # operand scratch: rows ROW_BYTES apart (TMA needs 16, its 128-byte
    # swizzled box rows read best at 128), no wider than needed
    row = G.ROW_BYTES // itemsize
    for ld, width in ((plan.ldz, d), (plan.ldr, n)):
        assert ld >= width and (ld * itemsize) % G.ROW_BYTES == 0 and ld - width < row
    assert plan.ldz % G.GLM_TILES[dtype].align == 0


def test_plan_at_the_mxu_shape():
    """The MXU-scale plans on an H100 (132 multiprocessors)."""
    assert G.plan_glm(256, 131072, 1024, "bf16", 132) == G.GlmPlan(
        ldz=1024, ldr=131072, ldg=1024, row_tiles=1024, splits=12, rows_per_split=10944)
    assert G.plan_glm(256, 131072, 1024, "f32", 132) == G.GlmPlan(
        ldz=1024, ldr=131072, ldg=1024, row_tiles=1024, splits=16, rows_per_split=8192)


def test_plan_at_the_covtype_shapes():
    """The covtype cells' narrow plans on an H100: eight chain tiles of 128
    in 33 splits (264 blocks, two on each multiprocessor), and one tile of
    64 in 260 splits."""
    assert G.plan_glm(1024, 581012, 55, "f32", 132) == G.GlmPlan(
        ldz=0, ldr=0, ldg=56, row_tiles=33, splits=33, rows_per_split=17664, chain_tile=128)
    assert G.plan_glm(64, 581012, 55, "f32", 132) == G.GlmPlan(
        ldz=0, ldr=0, ldg=56, row_tiles=260, splits=260, rows_per_split=2240, chain_tile=64)


WIDTHS = [1, 2, 3, 7, 32, 33, 55, 64, 65, 96, 127, 128, 129, 200, 1024, 1025]


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", sorted(set(WIDTHS) | {G.NARROW_MAX_D, G.NARROW_MAX_D + 1}))
def test_narrow_pass_by_width(d, dtype, sms):
    """f32 takes the narrow pass exactly up to the threshold, bf16 never;
    its splits cover every row once in one wave, with no residual scratch."""
    narrow = dtype == "f32" and d <= G.NARROW_MAX_D
    assert G.takes_narrow_pass(d, dtype) == narrow
    for c, n in ((1024, 581012), (64, 581012), (100, 1037), (1, 1), (65, 64 * 132 * 3 + 1)):
        plan = G.plan_glm(c, n, d, dtype, sms)
        assert plan.narrow == narrow
        if not narrow:
            assert plan == G.plan_two_pass(c, n, d, dtype, sms)
            assert "resid" in plan.scratch_shapes(c)
            continue
        assert plan == G.plan_narrow(c, n, d, sms)
        assert plan.chain_tile == (64 if c <= 64 else 128)
        _check_rows_covered(plan, n, G.NARROW_TILES.rows)
        blocks = -(-c // plan.chain_tile) * plan.splits
        assert blocks <= G.NARROW_TILES.blocks_per_sm * sms or plan.splits == 1  # one wave
        assert set(plan.scratch_shapes(c)) == {"ll_part", "g_part"}  # no [C, N] residual


def test_narrow_pass_has_a_bound():
    assert G.NARROW_MAX_D <= G.NARROW_TILES.max_depth
    with pytest.raises(ValueError, match="narrow pass takes"):
        G.plan_narrow(64, 100, G.NARROW_TILES.max_depth + 1, 132)


def _bern_data(d, dtype, n=50, align_x=True, family="bernoulli_logit"):
    rng = np.random.RandomState(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return G.build_glm_data(family, x, y, np.zeros(n), np.zeros(d), np.ones(d),
                            u=np.zeros(d) if family == "normal_learned" else None,
                            dtype=dtype, device="cpu", align_x=align_x), x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 7, 32, 33])
def test_build_aligns_bernoulli_rows(dtype, d):
    data, x = _bern_data(d, dtype)
    assert G.x_row_aligned(data.x)
    assert tuple(data.x.shape) == x.shape and data.x.stride(1) == 1
    assert data.x.stride(0) * data.x.element_size() % G.ROW_BYTES == 0
    assert data.x.stride(0) - d < G.ROW_BYTES // data.x.element_size()
    want = torch.as_tensor(x)
    if dtype == "bf16":
        want = want.to(torch.bfloat16)
    assert torch.equal(data.x, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 33, 1025])
def test_build_aligns_normal_rows(dtype, d):
    """K3/K4 read X as K1/K2 do: rows ROW_BYTES apart, D=1025 (the
    linear-Gaussian regression's z = [sigma, w]) through padded rows."""
    data, x = _bern_data(d, dtype, n=5, family="normal_learned")
    assert G.x_row_aligned(data.x) and tuple(data.x.shape) == x.shape
    assert data.x.stride(0) * data.x.element_size() % G.ROW_BYTES == 0
    assert data.x.stride(0) - d < G.ROW_BYTES // data.x.element_size()
    want = torch.as_tensor(x)
    assert torch.equal(data.x, want.to(torch.bfloat16) if dtype == "bf16" else want)


def test_readers_of_contiguous_x_keep_it():
    """K5 (align_x=False) reads X contiguous, and an X whose rows are
    already aligned is not copied; K3/K4 (normal_learned) now read aligned
    rows like K1/K2."""
    normal, _ = _bern_data(7, "bf16", family="normal_learned")
    assert G.x_row_aligned(normal.x) and not normal.x.is_contiguous()
    plain, _ = _bern_data(7, "f32", align_x=False)
    assert plain.x.is_contiguous()
    aligned, _ = _bern_data(32, "f32")  # already aligned: no padded copy
    assert aligned.x.is_contiguous()


def test_wrapper_check_refuses_unaligned_x():
    data, _ = _bern_data(7, "f32", align_x=False)  # rows 28 bytes apart
    z = torch.zeros((3, 7))
    with pytest.raises(ValueError, match="laid out as build_glm_data"):
        G.kernel_for("bernoulli_logit", "f32")._check(z, data)
    G.kernel_for("bernoulli_logit", "f32")._check(z, _bern_data(7, "f32")[0])
    normal, _ = _bern_data(7, "f32", align_x=False, family="normal_learned")
    with pytest.raises(ValueError, match="laid out as build_glm_data"):
        G.kernel_for("normal_learned", "f32")._check(z, normal)
    G.kernel_for("normal_learned", "f32")._check(z, _bern_data(7, "f32", family="normal_learned")[0])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cpu_wrapper_on_padded_rows_is_the_plain_version(dtype):
    padded, _ = _bern_data(7, dtype)
    packed = padded._replace(x=padded.x.contiguous())
    z = torch.as_tensor(np.random.RandomState(1).normal(size=(5, 7)).astype(np.float32))
    v, g = G.kernel_for("bernoulli_logit", dtype)(z, padded)
    v_ref, g_ref = packed.plain(z)
    torch.testing.assert_close(v, v_ref, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cpu_wrapper_on_padded_normal_rows_is_the_plain_version(dtype):
    padded, _ = _bern_data(7, dtype, family="normal_learned")
    packed = padded._replace(x=padded.x.contiguous())
    z = torch.as_tensor(np.random.RandomState(1).normal(size=(5, 7)).astype(np.float32))
    v, g = G.kernel_for("normal_learned", dtype)(z, padded)
    v_ref, g_ref = packed.plain(z)
    torch.testing.assert_close(v, v_ref, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grad_given_the_plain_residual_is_the_plain_gradient(dtype):
    z = torch.as_tensor(np.random.RandomState(2).normal(size=(4, 7)).astype(np.float32))
    for family in ("bernoulli_logit", "normal_learned"):
        data, _ = _bern_data(7, dtype, family=family)
        data = data._replace(u=torch.linspace(-0.2, 0.3, 7), c0=0.4)
        r32 = G.residual_reference(z, data)
        resid = r32.to(torch.bfloat16) if dtype == "bf16" else r32
        assert torch.equal(G.grad_given_residual(resid, z, data), data.plain(z)[1]), family


def _ulp(t):
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def test_bf16_rounding_flips():
    r32 = torch.tensor([0.3, -0.3, 0.7, 1e-3])
    unit = _ulp(r32)
    flips, units = G.bf16_rounding_flips(r32.to(torch.bfloat16), r32, unit)
    assert not flips.any() and not units.any()
    # the other bf16 neighbour: as far as the midpoint between the two
    flips, units = G.bf16_rounding_flips(_other_neighbour(r32), r32, unit)
    mid_units = ((r32.view(torch.int32) & 0xFFFF) - 0x8000).abs().double()
    assert flips.all() and torch.equal(units, mid_units)
    two_away = r32.to(torch.bfloat16).float() * 1.02  # several bf16 units off
    flips, units = G.bf16_rounding_flips(two_away.to(torch.bfloat16), r32, unit)
    assert flips.all() and (units > 32768).all()
    # 0 units on the midpoint, 32768 on a bf16 value; a unit twice as coarse halves them
    tie = torch.tensor([0x3E998000, 0x3E990000], dtype=torch.int32).view(torch.float32)
    assert G.bf16_rounding_flips(_other_neighbour(tie), tie, _ulp(tie))[1].tolist() == [0, 32768]
    assert G.bf16_rounding_flips(_other_neighbour(tie), tie, 2 * _ulp(tie))[1].tolist() == [0, 16384]


def test_residual_unit_of_a_normal_residual_is_locs():
    """y - loc is exact only to the last place of loc's absolute terms: a
    residual near 0 gets that unit, not its own."""
    data, _ = _bern_data(3, "f32", n=4, family="normal_learned")
    z = torch.tensor([[1.0, -2.0, 0.5]])
    r32 = G.residual_reference(z, data)
    terms = z.abs() @ data.x.abs().T
    want = _ulp(torch.maximum(terms, data.y.abs()[None, :]))
    assert torch.equal(G.residual_unit(r32, z, data), want)
    assert (want >= _ulp(r32)).all()
    bern, _ = _bern_data(3, "f32", n=4)
    rb = G.residual_reference(z, bern)
    assert torch.equal(G.residual_unit(rb, z, bern), _ulp(rb))


def _other_neighbour(r32):
    """The bf16 neighbour of each f32 value that round-to-nearest does not pick."""
    bits = r32.view(torch.int32)
    down = (bits & ~0xFFFF).view(torch.float32)
    up = ((bits & ~0xFFFF) + 0x10000).view(torch.float32)
    return torch.where(down.to(torch.bfloat16) == r32.to(torch.bfloat16), up, down).to(torch.bfloat16)


def _bf16_case(n_ties, family="bernoulli_logit", n=400):
    """bf16 data, z, the plain f32 residual and a kernel's bf16 residual:
    the plain one rounded, with ``n_ties`` residuals of chain 1 moved to
    their other bf16 neighbour.  Those are residuals that lie within
    TIE_UNITS of the midpoint, where a kernel's last-bit difference in the
    linear predictor can move them (ties), and the mask of the moved ones."""
    rng = np.random.RandomState(4)
    c, d = 3, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    if family == "bernoulli_logit":
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    else:
        y = rng.normal(size=n).astype(np.float32)
    data = G.build_glm_data(family, x, y, 0.1 * rng.normal(size=n), np.zeros(d), np.ones(d),
                            u=np.linspace(-0.3, 0.3, d) if family == "normal_learned" else None,
                            c0=0.2, ll_scale=1.7, dtype="bf16", device="cpu")
    z = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32))
    r32 = G.residual_reference(z, data)
    other = _other_neighbour(r32)
    _, units = G.bf16_rounding_flips(other, r32, G.residual_unit(r32, z, data))
    near = torch.zeros_like(units, dtype=torch.bool)
    near[1] = units[1] <= G.TIE_UNITS
    near[1, torch.cumsum(near[1].int(), 0) > n_ties] = False
    assert int(near.sum()) == n_ties
    return data, z, r32, torch.where(near, other, r32.to(torch.bfloat16)), near


@pytest.mark.parametrize("n_ties", [0, 1, 3])
def test_bf16_readings_bound_the_move_of_ties(n_ties):
    data, z, r32, r16, near = _bf16_case(n_ties)
    g_ref = data.plain(z)[1]
    g = G.grad_given_residual(r16, z, data)  # a kernel with these ties
    r = G.bf16_residual_readings(g, r16, z, data, g_ref)
    assert r["resid_flips"] == n_ties and r["flips_legal"]
    assert r["flip_share"] == n_ties / r16.numel()
    assert r["grad_given_resid_rel"] == 0.0
    if n_ties == 0:
        assert r["flip_allowance_rel"] == 0.0 and r["grad_max_rel"] == 0.0
        return
    # the allowance bounds the ties' move (up to the f32 rounding of the two
    # products, which the gates' TOL covers), and is its sum of one bf16
    # unit times ll_scale times the row's max|X| over max(max|g_ref|, 1)
    assert 0.0 < r["grad_max_rel"] <= r["flip_allowance_rel"] + 1e-6
    rows = near[1]
    units = (r16[1, rows].float() - r32[1, rows].to(torch.bfloat16).float()).abs()
    want = 1.7 * float((units * data.x[rows].float().abs().amax(1)).sum())
    assert r["flip_allowance_rel"] == pytest.approx(want / max(float(g_ref.abs().max()), 1.0))


@pytest.mark.parametrize("n_ties", [1, 3])
def test_normal_bf16_readings_scale_the_allowance_with_e2(n_ties):
    """A K4 tie moves the gradient through e2 = exp(-2 s) of its chain."""
    data, z, r32, r16, near = _bf16_case(n_ties, "normal_learned")
    g_ref = data.plain(z)[1]
    g = G.grad_given_residual(r16, z, data)
    r = G.bf16_residual_readings(g, r16, z, data, g_ref)
    assert r["resid_flips"] == n_ties and r["flips_legal"] and r["grad_given_resid_rel"] == 0.0
    assert 0.0 < r["grad_max_rel"] <= r["flip_allowance_rel"] + 1e-6
    rows = near[1]
    step = (r16[1, rows].float() - r32[1, rows].to(torch.bfloat16).float()).abs()
    e2 = float(torch.exp(-2.0 * (z[1] @ data.u + data.c0)))
    assert e2 != pytest.approx(1.0, abs=0.05)
    want = 1.7 * e2 * float((step * data.x[rows].float().abs().amax(1)).sum())
    assert r["flip_allowance_rel"] == pytest.approx(want / max(float(g_ref.abs().max()), 1.0))


def test_bf16_readings_refuse_the_unrounded_residual():
    """The control (no bf16 rounding of z or the residual) is no set of ties."""
    data, z, _, _, _ = _bf16_case(0, n=40)
    ctl_data = data._replace(x=data.x.float())
    g_ref, (_, g_ctl) = data.plain(z)[1], ctl_data.plain(z)
    r_ctl = G.residual_reference(z, ctl_data)
    r = G.bf16_residual_readings(g_ctl, r_ctl, z, data, g_ref)
    assert r["resid_flips"] > 0.9 * r_ctl.numel() and not r["flips_legal"]
    assert r["flip_allowance_rel"] < r["grad_max_rel"]  # only ties earn an allowance


def test_normal_bf16_readings_refuse_the_unrounded_residual():
    """K4's control: its residuals differ nearly everywhere and are no bf16
    values, so none is a tie or earns an allowance."""
    data, z, _, _, _ = _bf16_case(0, "normal_learned")
    ctl_data = data._replace(x=data.x.float())
    g_ref, (_, g_ctl) = data.plain(z)[1], ctl_data.plain(z)
    r_ctl = G.residual_reference(z, ctl_data)
    r = G.bf16_residual_readings(g_ctl, r_ctl, z, data, g_ref)
    assert r["resid_flips"] > 0.9 * r_ctl.numel() and not r["flips_legal"]
    assert r["flip_allowance_rel"] == 0.0 and r["grad_max_rel"] > 1e-4


def test_bernoulli_data_carries_its_own_scratch():
    a, _ = _bern_data(7, "bf16")
    b, _ = _bern_data(7, "bf16")
    assert isinstance(a.scratch, G.GlmScratch) and a.scratch is not b.scratch
    assert a.scratch.key is None  # filled at the first launch on a card
    normal = _bern_data(7, "f32", family="normal_learned")[0].scratch
    assert isinstance(normal, G.GlmScratch) and normal is not a.scratch and normal.key is None


def _csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdio.h>\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text('#pragma once\nint b;\n')
    (tmp_path / "unused.cuh").write_text('int u;\n')
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    return tmp_path


def test_digest_follows_included_headers(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    assert [p.name for p in cuda_build.included_headers("k")] == ["a.cuh", "b.cuh"]
    before = cuda_build.library_path("k")
    (csrc / "unused.cuh").write_text('int u2;\n')  # not included: same build
    assert cuda_build.library_path("k") == before
    (csrc / "b.cuh").write_text('#pragma once\nint b2;\n')  # included through a.cuh
    after_b = cuda_build.library_path("k")
    assert after_b != before
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\nint a2;\n')
    assert cuda_build.library_path("k") not in (before, after_b)


def test_digest_follows_compile_and_link_flags(tmp_path, monkeypatch):
    _csrc(tmp_path, monkeypatch)
    before = cuda_build.library_path("k")
    monkeypatch.setattr(cuda_build, "LINK_FLAGS", ["-lcuda"])
    linked = cuda_build.library_path("k")
    assert linked != before
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", [*cuda_build.NVCC_FLAGS, "-lineinfo"])
    assert cuda_build.library_path("k") not in (before, linked)


def test_the_repo_kernels_include_their_headers():
    assert [p.name for p in cuda_build.included_headers("glm_vg")] == ["glm_sm90.cuh"]
    assert cuda_build.included_headers("leapfrog") == []


# ---------------------------------------------------------------------------
# K5's planner (ops/leapfrog.py plan_leapfrog)
# ---------------------------------------------------------------------------

def _gate_rows(d, limit):
    """The most rows K5's size gate admits at width d: X [N][d | 1] and one
    chain's z, r, g and 32 residuals within the limit."""
    return (limit // 4 - 3 * d - 32) // (d | 1)


def _check_leapfrog_plan(c, n, d, limit, sms):
    plan = TL.plan_leapfrog(c, n, d, limit, sms)
    assert plan.smem_bytes <= limit
    assert plan.smem_bytes == 4 * TL.leapfrog_layout_floats(
        n, d, plan.chains, plan.warps, plan.rows_per_tile, plan.row_slices, plan.state_in_smem)
    # every chain in exactly one block: block b takes [b G, min((b + 1) G, C))
    assert plan.chains in TL.K5_CHAINS_PER_BLOCK
    assert (plan.blocks - 1) * plan.chains < c <= plan.blocks * plan.chains
    assert plan.chains == 1 or plan.chains <= -(-c // sms)  # one wave where C allows
    assert 1 <= plan.warps <= TL.K5_MAX_WARPS
    assert plan.rows_per_tile % 4 == 0 and 4 <= plan.rows_per_tile <= -(-n // 4) * 4
    # product 2: one (slice, 32-column chunk) item per warp, or one slice
    assert plan.row_slices == 1 or plan.row_slices * -(-d // 32) <= plan.warps
    return plan


@pytest.mark.parametrize("limit", [TL.SMEM_PER_BLOCK_OPTIN, 101376])
@pytest.mark.parametrize("d", [1, 2, 7, 31, 32, 33, 70, 128, 1024, 4000])
def test_leapfrog_plan_for_every_shape_the_gate_admits(d, limit):
    """Up to the gate's edge every (C, N) has a plan within the limit, and
    the gate's answers are those of X plus one chain's state (unchanged
    since the one-warp-per-chain kernel)."""
    edge = _gate_rows(d, limit)
    assert edge >= 1
    rows = sorted({1, 2, 3, 20, 63, 64, 65, 300, 1000, edge - 1, edge}
                  | set(range(1, edge, max(1, edge // 40))) - {0})
    for n in (r for r in rows if r <= edge):
        assert TL.leapfrog_fits(n, d, limit)
        for c in (1, 13, 64, 131, 132, 256, 1024, 4097):
            for sms in (132, 7):
                _check_leapfrog_plan(c, n, d, limit, sms)
    assert TL.leapfrog_smem_bytes(edge, d, 1) <= limit < TL.leapfrog_smem_bytes(edge + 1, d, 1)
    assert not TL.leapfrog_fits(edge + 1, d, limit)
    with pytest.raises(ValueError, match="size gate"):
        TL.plan_leapfrog(64, edge + 1, d, limit)


def test_leapfrog_plan_at_the_floor_and_conjugate_shapes():
    """On an H100: eight chains and sixteen warps a block at the floor
    (128 blocks, one wave; the whole N=1000 in one tile, r and g in
    shared memory); one chain and one warp at the conjugate shape."""
    assert TL.plan_leapfrog(1024, 1000, 32) == TL.LeapfrogPlan(
        chains=8, warps=16, rows_per_tile=1000, row_slices=16, state_in_smem=True,
        smem_bytes=184032, blocks=128)
    assert TL.plan_leapfrog(64, 20, 1) == TL.LeapfrogPlan(
        chains=1, warps=1, rows_per_tile=20, row_slices=1, state_in_smem=True,
        smem_bytes=224, blocks=64)


@pytest.mark.parametrize("c,n,d", [(256, 1750, 32), (256, 1757, 32), (13, 1000, 32),
                                   (1, 300, 7), (256, 700, 70), (130, 700, 70),
                                   (512, 1999, 2), (512, 998, 3)])
def test_leapfrog_plan_of_the_card_tests(c, n, d):
    """The shapes tests/test_torch_kernels_cuda.py runs K5 at: near the
    gate's edge (r and g move to the outputs at N=1757), fewer chains than
    multiprocessors, one chain, D over three 32-column chunks, and the
    AR(1) / AR(2) paths' narrow D (the whole lag matrix in one tile)."""
    plan = _check_leapfrog_plan(c, n, d, TL.SMEM_PER_BLOCK_OPTIN, 132)
    if n == 1757:
        assert not plan.state_in_smem and plan.rows_per_tile < n
    if c <= 132:
        assert plan.chains == 1 and plan.blocks == c
    if d == 70:
        assert plan.row_slices * 3 <= plan.warps and plan.rows_per_tile == n
