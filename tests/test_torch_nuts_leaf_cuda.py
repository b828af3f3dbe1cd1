"""Kernel K7, the NUTS leaf's bookkeeping (``csrc/nuts_leaf.cu``), against
the plain leaf (``_NutsTree.plain_leaf``) on the card.

Two trees start every leaf index of a depth-8 tree from the same state and
draws, the one through the plain leaf and the other through K7; every
buffer that a later leaf or ``transition`` reads must agree.  These tests
need a card: they are marked ``cuda`` and skip without one.  The file
imports neither JAX nor brancher_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nuts_leaf_cuda.py -q

The state is built away from ties, so that every decision (a U-turn, a
swap, a take, a divergence) is the same in both: each momentum-like vector
is a coefficient times a fixed positive direction w plus small noise, the
coefficients of the momenta half-integers and those of the momentum sums
integers, so that every sum of them the U-turn dots take is at least a
half from 0; the uniforms are drawn at least 0.05 from the thresholds
they are compared with, and the log weights sit far from the divergence
limit but where planted.  The potential is linear (a fixed gradient), with
its value set from the leaf's kinetic energy so that a leaf's log weight
is a chosen number.
"""
import math

import pytest
import torch

import brancher_torch.inference.vectorized_nuts as TV
from brancher_torch.ops.nuts_leaf import BUFFERS, NUTS_LEAF, tree_shapes

pytestmark = pytest.mark.cuda

DEPTH = 8
MAX_DELTA = 1000.0
# Limits on |kernel - plain| <= atol + rtol |plain|.  Every elementwise
# value is the plain leaf's bit for bit (each product and sum rounded on
# its own, as its ops do); the kinetic energy and the dots are summed in
# another order, which moves the per-chain log weights and accept sums by a
# few units in the last place of an O(1) number.
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the tree buffers compared: the state, the flags and n
STATE = ("ends", "mov", "prop", "sp", "prop_val", "sp_val", "h0", "lw", "s_lw", "dirn",
         "sum_acc", "cnt", "r_sum", "s_cum", "s_failed", "active", "diverging", "r_ck", "rs_ck")
FLAGS = ("s_failed", "active", "diverging")
# written at a subtree's start (the head) for every chain by the plain
# leaf, for the active ones by K7
START = ("dirn", "mov", "s_lw", "s_cum", "s_failed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 has no CPU mode")
    yield torch.device("cuda")
    torch.cuda.synchronize()  # no launch of a test runs on into the next


def _state(c, d, dtype, device, seed):
    """A tree state away from ties (module docstring), on ``device``."""
    g = torch.Generator().manual_seed(seed)
    w = (0.5 + torch.rand(d, generator=g, dtype=torch.float64)) / math.sqrt(d)

    def along(shape, half):
        coef = torch.randint(-2, 3, shape, generator=g).to(torch.float64) + (0.5 if half else 0.0)
        return coef[..., None] * w + 0.02 * w * torch.randn((*shape, d), generator=g,
                                                           dtype=torch.float64)

    def normal(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    def coin(p):
        return torch.rand(c, generator=g) < p

    # positions, and gradients of the size of w: a half kick moves a
    # momentum's coefficient by a few thousandths
    s = {"ends": torch.stack([torch.stack([normal(c, d), w * normal(c, d), along((c,), True)])
                              for _ in range(2)]),
         "mov": torch.stack([normal(c, d), w * normal(c, d), along((c,), True)]),
         "prop": normal(2, c, d), "sp": normal(2, c, d),
         "r_sum": along((c,), False), "s_cum": along((c,), False),
         "r_ck": along((DEPTH + 2, c), True), "rs_ck": along((DEPTH + 2, c), False),
         "prop_val": normal(c), "sp_val": normal(c), "h0": normal(c), "lw": 2 * normal(c),
         "s_lw": 2 * normal(c), "dirn": torch.where(coin(0.5), 1.0, -1.0).double(),
         "sum_acc": 3 * torch.rand(c, generator=g, dtype=torch.float64),
         "cnt": torch.randint(0, 9, (c,), generator=g).double(),
         "s_failed": coin(0.15), "active": ~coin(0.15), "diverging": coin(0.1),
         "eps": torch.tensor(0.01, dtype=torch.float64),
         "inv_mass": 0.5 + 1.5 * torch.rand(d, generator=g, dtype=torch.float64),
         # the potential: a fixed gradient, the leaf's log weights and the
         # chains whose value is not finite or that diverge
         "grad": w * normal(c, d), "lw_leaf": 3 * normal(c), "dir_pos": coin(0.5),
         "planted": torch.randint(0, 12, (c,), generator=g)}
    return {k: (v.to(device, dtype) if v.is_floating_point() else v.to(device))
            for k, v in s.items()}


def _load(tree, s, n):
    for f in STATE + ("eps", "inv_mass"):
        getattr(tree, f).copy_(s[f])
    tree.n = n.clone()


def _potential(tree, s):
    """The linear potential of the state: gradient ``s["grad"]`` and the
    value that gives the leaf the log weight ``s["lw_leaf"]``, computed
    from the tree's moving end after the head; chains of ``planted`` 0, 1
    and 2 give NaN, +inf and -inf, those of 3 a divergent log weight."""
    def vg(z):
        f64 = torch.float64
        half = (0.5 * (tree.eps.to(f64) * tree.dirn.to(f64)))[:, None]
        r = tree.mov[2].to(f64) + half * tree.mov[1].to(f64) + half * s["grad"].to(f64)
        ke = 0.5 * (r * r * tree.inv_mass.to(f64)).sum(-1)
        lw = torch.where(s["planted"] == 3, -2.0 * MAX_DELTA, s["lw_leaf"].to(f64))
        val = ke - tree.h0.to(f64) + lw
        for k, x in ((0, math.nan), (1, math.inf), (2, -math.inf)):
            val = torch.where(s["planted"] == k, x, val)
        return val.to(z.dtype), s["grad"].clone()
    return vg


def _uniforms(s, start, gen):
    """(swap_u, take_u) at least 0.05 from every threshold they could meet:
    exp(lw_leaf - s_lw'), and exp(min(s_lw' - lw, 0)) for s_lw' the
    subtree's weight with and without this leaf."""
    f64 = torch.float64
    lw_leaf = torch.where(s["planted"] == 3, -2.0 * MAX_DELTA, s["lw_leaf"].to(f64))
    s_lw0 = torch.where(start, -math.inf, s["s_lw"].to(f64))
    s_lw1 = torch.logaddexp(s_lw0, lw_leaf)
    lw = s["lw"].to(f64)
    out = []
    for ps in ([torch.exp(lw_leaf - s_lw1)],
               [torch.exp(torch.clamp(x - lw, max=0.0)) for x in (s_lw0, s_lw1)]):
        u = torch.rand(start.shape, generator=gen, dtype=f64, device=start.device)
        for _ in range(50):
            near = torch.zeros_like(start)
            for p in ps:
                near |= (u - p).abs() < 0.05
            if not bool(near.any()):
                break
            u = torch.where(near, torch.rand(u.shape, generator=gen, dtype=f64,
                                             device=u.device), u)
        assert not bool(near.any())
        out.append(u.to(s["lw"].dtype))
    return out


def _pairs(plain, kern, entry, live, active):
    """(field, kernel's, plain's) for every buffer compared: the plain
    leaf's value where K7 writes, the entry state where it does not."""
    kdim = kern.r_ck.shape[0] - 1
    for f in STATE:
        got, want = getattr(kern, f), getattr(plain, f)
        if f in ("r_ck", "rs_ck"):
            # the checkpoint rows of the live chains; a chain that is not
            # live is not written (the spare row kdim neither: nothing reads it)
            got = got[:kdim]
            want = torch.where(live[:, None], want[:kdim], entry[f][:kdim])
        elif f in START:
            mask = {1: active, 2: active[:, None], 3: active[None, :, None]}[got.dim()]
            want = torch.where(mask, want, entry[f])
        yield f, got, want
    yield "n", kern.n, plain.n


def _compare(plain, kern, entry, live, active, dtype):
    tol = TOL[dtype]
    for f, got, want in _pairs(plain, kern, entry, live, active):
        if f in FLAGS + ("n",):
            assert torch.equal(got, want), f
        else:
            torch.testing.assert_close(got, want, rtol=tol, atol=tol, equal_nan=True, msg=f)


def _every_leaf(device, d, c, dtype, per_chain, leaves=range(2**DEPTH), seed=None, check=_compare):
    """The plain leaf and K7 at each of ``leaves`` from the state of
    ``seed`` (by default one of d and c), with n one index for every chain
    (the lockstep engine) or one a chain, the leaf index plus the chain's
    (the pipelined engine: a chain at n = 0 waits between draws and is not
    active); ``check(plain, kern, entry, live, active, dtype)`` after each."""
    s = _state(c, d, dtype, device, seed=1000 * d + c if seed is None else seed)
    plain, kern = (TV._NutsTree(c, d, dtype, device, DEPTH, MAX_DELTA) for _ in range(2))
    gen = torch.Generator(device=device).manual_seed(d + c)
    chains = torch.arange(c, device=device)
    for leaf in leaves:
        if leaf == 0 and not per_chain:
            continue
        n = ((leaf + chains) % 2**DEPTH if per_chain
             else torch.tensor([leaf], device=device))
        entry = dict(s, active=s["active"] & (n > 0))
        rows = n.expand(c)
        start = kern.flags[rows, 0]
        active = entry["active"]
        live = active & (start | ~entry["s_failed"])
        swap_u, take_u = _uniforms(s, start, gen)
        for tree in (plain, kern):
            _load(tree, entry, n)
        plain.plain_leaf(_potential(plain, s), s["dir_pos"], swap_u, take_u)
        kern.leaf(_potential(kern, s), s["dir_pos"], swap_u, take_u)
        check(plain, kern, entry, live, active, dtype)


@pytest.mark.parametrize("per_chain", [False, True], ids=["n1", "nC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("c", [1, 64, 1024])
@pytest.mark.parametrize("d", [1, 3, 55, 3002])
def test_kernel_leaf_matches_the_plain_leaf(cuda, d, c, dtype, per_chain):
    """Every leaf index of a depth-8 tree, with n one index for every chain
    or one a chain."""
    _every_leaf(cuda, d, c, dtype, per_chain)


@pytest.mark.parametrize("per_chain", [False, True], ids=["n1", "nC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("d", [100, 3100])
def test_kernel_leaf_matches_the_plain_leaf_over_chunks(cuda, d, dtype, per_chain):
    """A chain wider than the columns its threads hold in registers (64 a
    warp, 3,072 a block) takes them in chunks, each round of sums re-reads
    them and the write phase re-reads all but the last."""
    _every_leaf(cuda, d, 64, dtype, per_chain)


def test_the_state_takes_every_branch_of_the_leaf(cuda):
    """The state above takes every branch of the leaf: at C = 1024, d = 55
    over the leaves of a depth-8 tree some live chains swap, take, merge,
    turn, fail on a U-turn and on a divergence, and some chains are stopped
    or failed before the leaf."""
    c, d, dtype = 1024, 55, torch.float32
    s = _state(c, d, dtype, cuda, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(7)
    seen = dict.fromkeys(("swap", "take", "merge", "u_turn", "divergence", "full_turn"), 0)
    for leaf in range(1, 2**DEPTH):
        tree = TV._NutsTree(c, d, dtype, cuda, DEPTH, MAX_DELTA)
        n = torch.tensor([leaf], device=cuda)
        _load(tree, s, n)
        start = tree.flags[n.expand(c), 0]
        swap_u, take_u = _uniforms(s, start, gen)
        live = s["active"] & (start | ~s["s_failed"])
        tree.leaf(_potential(tree, s), s["dir_pos"], swap_u, take_u)
        is_end = bool(tree.flags[leaf, 1])
        fail = live & tree.s_failed
        seen["divergence"] += int((live & tree.diverging & ~s["diverging"]).sum())
        seen["u_turn"] += int((fail & ~tree.diverging).sum())
        seen["swap"] += int((live & (tree.sp_val != s["sp_val"])).sum())
        if is_end:
            merged = live & ~tree.s_failed
            seen["merge"] += int(merged.sum())
            seen["take"] += int((merged & (tree.prop_val != s["prop_val"])).sum())
            seen["full_turn"] += int((merged & ~tree.active).sum())
    assert all(v > 0 for v in seen.values()), seen


def test_two_launches_give_identical_bits(cuda):
    c, d, dtype = 1024, 3002, torch.float32
    s = _state(c, d, dtype, cuda, seed=3)
    trees = [TV._NutsTree(c, d, dtype, cuda, DEPTH, MAX_DELTA) for _ in range(2)]
    gen = torch.Generator(device=cuda).manual_seed(3)
    n = torch.tensor([63], device=cuda)  # an odd leaf checking five rows, at a subtree's end
    swap_u, take_u = _uniforms(s, trees[0].flags[n.expand(c), 0], gen)
    for tree in trees:
        _load(tree, s, n)
        tree.leaf(_potential(tree, s), s["dir_pos"], swap_u, take_u)
    for f in STATE + ("z_new",):
        assert torch.equal(getattr(trees[0], f), getattr(trees[1], f)), f


def test_launches_count_the_leaves(cuda):
    c, d, dtype = 64, 55, torch.float32
    s = _state(c, d, dtype, cuda, seed=4)
    tree = TV._NutsTree(c, d, dtype, cuda, DEPTH, MAX_DELTA)
    _load(tree, s, torch.tensor([1], device=cuda))
    before = NUTS_LEAF.launches
    for _ in range(5):
        tree.leaf(_potential(tree, s), s["dir_pos"], s["lw"] * 0 + 0.5, s["lw"] * 0 + 0.5)
    assert NUTS_LEAF.launches - before == 5
    assert int(tree.n) == 6


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    c, d = 8, 5
    gen = torch.Generator(device=cuda).manual_seed(8)
    u = torch.rand(c, device=cuda, generator=gen)
    ones = torch.ones(c, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        TV._NutsTree(c, d, torch.float16, cuda, DEPTH, MAX_DELTA)
    tree = TV._NutsTree(c, d, torch.float32, cuda, DEPTH, MAX_DELTA)
    buffers = {f: getattr(tree, f) for f in BUFFERS}
    assert set(tree_shapes(c, d, DEPTH + 1, 2**DEPTH)) == set(BUFFERS)
    with pytest.raises(ValueError, match="s_cum"):  # the right shape, not contiguous
        NUTS_LEAF.bind(dict(buffers, s_cum=torch.zeros((d, c), device=cuda).T), MAX_DELTA)
    with pytest.raises(TypeError, match="active"):
        NUTS_LEAF.bind(dict(buffers, active=torch.zeros(c, device=cuda)), MAX_DELTA)
    args = tree.leaf_args
    with pytest.raises(ValueError, match="n must be"):
        NUTS_LEAF.head(args, tree.n.to(torch.int32), ones)
    NUTS_LEAF.head(args, tree.n, ones)
    with pytest.raises(ValueError, match="grad_new"):
        NUTS_LEAF.tail(args, tree.n, torch.zeros(c, device=cuda),
                       torch.zeros((d, c), device=cuda).T, u, u)
    with pytest.raises(TypeError, match="val_new"):
        NUTS_LEAF.tail(args, tree.n, torch.zeros(c, device=cuda, dtype=torch.float64),
                       torch.zeros((c, d), device=cuda), u, u)
