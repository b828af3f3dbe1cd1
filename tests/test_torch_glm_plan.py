"""The K1/K2 pass planner, X's row layout and the kernel build's digest.

K1 and K2 (``brancher_torch/csrc/glm_bernoulli_sm90.cuh``) run only on a
card; what surrounds them is plain Python and is held here: the planner
(``ops/glm.py::plan_bernoulli``) must give the kernel the strides,
alignment, row tiles and row splits it checks, the data build must lay X's
rows 16 bytes apart, and the build digest must follow every header a
kernel source includes and the link flags.
"""
import numpy as np
import pytest
import torch

import brancher_torch.ops.glm as G
from brancher_torch.ops import cuda_build

torch.set_num_threads(2)

# (C, N, D): the floor, conjugate and MXU-scale shapes of chip_smoke.py,
# and its ragged one (no axis a multiple of 8)
SHAPES = {
    "floor": (1024, 1000, 32),
    "conjugate": (64, 20, 1),
    "mxu": (256, 131072, 1024),
    "ragged": (100, 1037, 33),
}
ITEMSIZE = {"f32": 4, "bf16": 2}


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_covers_every_row_once(shape, dtype, sms):
    c, n, d = SHAPES[shape]
    t = G.BERNOULLI_TILES[dtype]
    plan = G.plan_bernoulli(c, n, d, dtype, sms)
    # pass B's split s takes rows [s rows_per_split, min((s + 1) rows_per_split, N))
    rows = [(s * plan.rows_per_split, min((s + 1) * plan.rows_per_split, n))
            for s in range(plan.splits)]
    assert len(rows) == plan.splits >= 1
    assert rows[0][0] == 0 and rows[-1][1] == n
    for (a, b), (a2, _) in zip(rows, rows[1:]):
        assert b == a2  # contiguous, no overlap
    assert all(b > a for a, b in rows)  # no split is empty
    assert plan.rows_per_split % t.rows_b == 0  # splits are whole depth steps
    # pass A: one tile per rows_a rows, the last one not empty
    assert (plan.row_tiles - 1) * t.rows_a < n <= plan.row_tiles * t.rows_a
    # pass B runs in one wave, or has one split
    blocks = -(-c // t.chains_b) * -(-d // t.cols_b)
    assert plan.splits == 1 or blocks * plan.splits <= t.blocks_per_sm * sms


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_scratch_layout(shape, dtype):
    c, n, d = SHAPES[shape]
    plan = G.plan_bernoulli(c, n, d, dtype, 132)
    itemsize = ITEMSIZE[dtype]
    shapes = plan.scratch_shapes(c)
    assert shapes == {"z": (c, plan.ldz), "resid": (c, plan.ldr),
                      "ll_part": (c, plan.row_tiles), "g_part": (plan.splits, c, plan.ldg)}
    # operand scratch: rows 16 bytes apart (TMA, 16-byte copies), no wider
    # than needed
    for ld, width in ((plan.ldz, d), (plan.ldr, n)):
        assert ld >= width and (ld * itemsize) % 16 == 0 and ld - width < 16 // itemsize
    assert plan.ldz % G.BERNOULLI_TILES[dtype].align == 0
    # f32 gradient partials: rows a multiple of 4 floats (float4 / float2 stores)
    assert plan.ldg >= d and plan.ldg % 4 == 0 and plan.ldg - d < 4


def test_plan_at_the_mxu_shape():
    """The MXU-scale plans on an H100 (132 multiprocessors)."""
    assert G.plan_bernoulli(256, 131072, 1024, "bf16", 132) == G.BernoulliPlan(
        ldz=1024, ldr=131072, ldg=1024, row_tiles=1024, splits=12, rows_per_split=10944)
    assert G.plan_bernoulli(256, 131072, 1024, "f32", 132) == G.BernoulliPlan(
        ldz=1024, ldr=131072, ldg=1024, row_tiles=1024, splits=16, rows_per_split=8192)


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
    assert data.x.stride(0) * data.x.element_size() % 16 == 0
    assert data.x.stride(0) - d < 16 // data.x.element_size()
    want = torch.as_tensor(x)
    if dtype == "bf16":
        want = want.to(torch.bfloat16)
    assert torch.equal(data.x, want)


def test_readers_of_contiguous_x_keep_it():
    """K3/K4 (normal_learned) and K5 (align_x=False) read X contiguous."""
    normal, _ = _bern_data(7, "bf16", family="normal_learned")
    assert normal.x.is_contiguous()
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
def test_grad_given_the_plain_residual_is_the_plain_gradient(dtype):
    data, _ = _bern_data(7, dtype)
    z = torch.as_tensor(np.random.RandomState(2).normal(size=(4, 7)).astype(np.float32))
    r32 = G.bernoulli_residual_reference(z, data)
    resid = r32.to(torch.bfloat16) if dtype == "bf16" else r32
    assert torch.equal(G.bernoulli_grad_given_residual(resid, z, data), data.plain(z)[1])


def test_bf16_rounding_flips():
    r32 = torch.tensor([0.3, -0.3, 0.7, 1e-3])
    bits = r32.view(torch.int32)
    nearest = r32.to(torch.bfloat16)
    # the other bf16 neighbour of each value, one bf16 unit away
    down = (bits & ~0xFFFF).view(torch.float32)
    other = torch.where(down.to(torch.bfloat16) == nearest,
                        ((bits & ~0xFFFF) + 0x10000).view(torch.float32), down)
    flips, legal, units = G.bf16_rounding_flips(nearest, r32)
    assert not flips.any() and not legal.any()
    flips, legal, _ = G.bf16_rounding_flips(other.to(torch.bfloat16), r32)
    assert flips.all() and legal.all()
    two_away = nearest.float() * 1.02  # several bf16 units off: not a tie
    flips, legal, _ = G.bf16_rounding_flips(two_away.to(torch.bfloat16), r32)
    assert flips.all() and not legal.any()
    # distance from the midpoint in f32 units: 0 at a tie, 32768 on a bf16 value
    tie = torch.tensor([0x3E998000, 0x3E990000], dtype=torch.int32).view(torch.float32)
    assert G.bf16_rounding_flips(tie.to(torch.bfloat16), tie)[2].tolist() == [0, 32768]
    assert units.max() <= 32768


def _other_neighbour(r32):
    """The bf16 neighbour of each f32 value that round-to-nearest does not pick."""
    bits = r32.view(torch.int32)
    down = (bits & ~0xFFFF).view(torch.float32)
    up = ((bits & ~0xFFFF) + 0x10000).view(torch.float32)
    return torch.where(down.to(torch.bfloat16) == r32.to(torch.bfloat16), up, down).to(torch.bfloat16)


def _bf16_case(flip):
    """bf16 data, z, and the plain residual, rounded, with the residuals
    where ``flip`` [C, N] is true moved to their other bf16 neighbour."""
    rng = np.random.RandomState(4)
    c, n, d = 3, 40, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    data = G.build_glm_data("bernoulli_logit", x, y, 0.1 * rng.normal(size=n), np.zeros(d),
                            np.ones(d), ll_scale=1.7, dtype="bf16", device="cpu")
    z = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32))
    r32 = G.bernoulli_residual_reference(z, data)
    r16 = torch.where(torch.as_tensor(flip), _other_neighbour(r32), r32.to(torch.bfloat16))
    return data, z, r32, r16


@pytest.mark.parametrize("n_ties", [0, 1, 3])
def test_bf16_readings_bound_the_move_of_ties(n_ties):
    flip = np.zeros((3, 40), bool)
    flip[1, :n_ties] = True  # all in one chain
    data, z, r32, r16 = _bf16_case(flip)
    g_ref = data.plain(z)[1]
    g = G.bernoulli_grad_given_residual(r16, z, data)  # a kernel with these ties
    r = G.bf16_residual_readings(g, r16, z, data, g_ref)
    assert r["resid_flips"] == n_ties and r["flips_legal"]
    assert r["flip_share"] == n_ties / r16.numel()
    assert r["grad_given_resid_rel"] == 0.0
    if n_ties == 0:
        assert r["flip_allowance_rel"] == 0.0 and r["grad_max_rel"] == 0.0
        return
    # the allowance bounds the ties' move, and is its sum of one bf16 unit
    # times ll_scale times the row's max|X| over max(max|g_ref|, 1)
    assert 0.0 < r["grad_max_rel"] <= r["flip_allowance_rel"]
    units = (r16[1, :n_ties].float() - r32[1, :n_ties].to(torch.bfloat16).float()).abs()
    want = 1.7 * float((units * data.x[:n_ties].float().abs().amax(1)).sum())
    assert r["flip_allowance_rel"] == pytest.approx(want / max(float(g_ref.abs().max()), 1.0))


def test_bf16_readings_refuse_the_unrounded_residual():
    """The control (no bf16 rounding of z or the residual) is no set of ties."""
    data, z, _, _ = _bf16_case(np.zeros((3, 40), bool))
    ctl_data = data._replace(x=data.x.float())
    g_ref, (_, g_ctl) = data.plain(z)[1], ctl_data.plain(z)
    r_ctl = G.bernoulli_residual_reference(z, ctl_data)
    r = G.bf16_residual_readings(g_ctl, r_ctl, z, data, g_ref)
    assert r["resid_flips"] > 0.9 * r_ctl.numel() and not r["flips_legal"]
    assert r["flip_allowance_rel"] < r["grad_max_rel"]  # only ties earn an allowance


def test_bernoulli_data_carries_its_own_scratch():
    a, _ = _bern_data(7, "bf16")
    b, _ = _bern_data(7, "bf16")
    assert isinstance(a.scratch, G.BernoulliScratch) and a.scratch is not b.scratch
    assert a.scratch.key is None  # filled at the first launch on a card
    assert _bern_data(7, "f32", family="normal_learned")[0].scratch is None


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
    assert [p.name for p in cuda_build.included_headers("glm_vg")] == ["glm_bernoulli_sm90.cuh"]
    assert cuda_build.included_headers("leapfrog") == []
