"""perform_inference(matmul_precision=...): the port follows what JAX does
on its accelerator (bf16 operands, f32 accumulation for every product in
the loss), inside the run only.  JAX's CPU backend ignores the setting,
so the port's bf16 loss cannot be held against JAX here: it is held
against the same loss written out with bf16-rounded operands."""
import math

import jax
import numpy as np
import pytest
import torch

import brancher_tpu as BJ
import brancher_tpu.functions as BFJ
import brancher_tpu.inference.guides as JG
import brancher_tpu.inference.svi as JS
import brancher_torch as BT
import brancher_torch.functions as BFT
import brancher_torch.inference.guides as TG
import brancher_torch.inference.svi as TS
from brancher_torch.bridge import params_to_torch

torch.set_num_threads(2)

N, D, S = 64, 8, 4


def _data():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = (rng.uniform(size=N) < 0.5).astype(np.int32)
    return x, y


def _logreg(pkg, bf):
    x, y = _data()
    w = pkg.NormalVariable(np.zeros(D, np.float32), np.ones(D, np.float32), "w")
    yv = pkg.BernoulliVariable(logits=bf.matmul(x, w), name="y")
    yv.observe(y)
    return pkg.ProbabilisticModel([yv])


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _hand_loss(params, eps, rounded):
    """The mean-field ELBO of the logistic model written out: each logit a
    product of x and a draw of w, their operands rounded to bf16 when
    ``rounded``."""
    x, y = (torch.as_tensor(a) for a in _data())
    loc, log_scale = params["loc"], params["log_scale"]
    w = loc + torch.exp(log_scale) * eps  # [S, D]
    log_q = torch.sum(-0.5 * eps**2 - 0.5 * math.log(2 * math.pi) - log_scale, dim=-1)
    xx, ww = (_bf16(x), _bf16(w)) if rounded else (x, w)
    logits = torch.einsum("nd,sd->sn", xx.double(), ww.double()).float()  # exact sums of exact products
    ll = torch.sum(y * logits - torch.nn.functional.softplus(logits, threshold=1e9), dim=-1)
    prior = torch.sum(-0.5 * w**2 - 0.5 * math.log(2 * math.pi), dim=-1)
    return -torch.mean(ll + prior - log_q)


def _port_loss_and_draws(seed=1):
    comp = _logreg(BT, BFT).compiled("cpu")
    guide = TG.AutoMeanField(comp)
    gen = torch.Generator().manual_seed(seed)
    params = {"p": comp.initial_params, "q": guide.init_params(gen)}
    params["q"]["loc"] = params["q"]["loc"] + 0.5  # away from 0, so products are not tiny
    eps = torch.randn((S, comp.dim), generator=gen)
    return TS.ReverseKL().make_loss(comp, guide), params, eps


def test_bf16_loss_is_the_f32_loss_of_bf16_rounded_operands():
    loss_fn, params, eps = _port_loss_and_draws()
    with torch.no_grad():
        l32 = float(loss_fn(params, None, S, draws={"noise": eps}))
        with TS.matmul_precision_scope("bfloat16"):
            l16 = float(loss_fn(params, None, S, draws={"noise": eps}))
        h32 = float(_hand_loss(params["q"], eps, rounded=False))
        h16 = float(_hand_loss(params["q"], eps, rounded=True))
    # f32 sums of 8 products in two orders: 1e-5 of the loss
    np.testing.assert_allclose(l32, h32, rtol=1e-5)
    np.testing.assert_allclose(l16, h16, rtol=1e-5)
    # the rounding moves the loss by more than three times that
    assert abs(l16 - l32) > 3e-5 * abs(l32), (l16, l32)


@pytest.mark.parametrize("product", ["matmul", "operator", "mm", "bmm", "einsum", "tensordot",
                                     "linear"])
def test_every_product_rounds_its_operands_in_scope(product):
    rng = np.random.RandomState(2)
    a = torch.as_tensor(rng.normal(size=(5, 6)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(6, 3)).astype(np.float32))
    fns = {
        "matmul": lambda p, q: torch.matmul(p, q), "operator": lambda p, q: p @ q,
        "mm": lambda p, q: torch.mm(p, q), "bmm": lambda p, q: torch.bmm(p[None], q[None])[0],
        "einsum": lambda p, q: torch.einsum("ij,jk->ik", p, q),
        "tensordot": lambda p, q: torch.tensordot(p, q, dims=([1], [0])),
        "linear": lambda p, q: torch.nn.functional.linear(p, q.T),
    }
    fn = fns[product]
    plain = fn(a, b)
    with TS.matmul_precision_scope("bfloat16"):
        scoped = fn(a, b)
        under_vmap = torch.func.vmap(lambda row: fn(row[None], b)[0])(a)
    ref = (_bf16(a).double() @ _bf16(b).double()).float()
    np.testing.assert_allclose(scoped.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(under_vmap.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    assert float((plain - scoped).abs().max()) > 1e-4
    np.testing.assert_array_equal(fn(a, b).numpy(), plain.numpy())  # out of scope again


def test_previous_precision_is_restored_after_perform_inference():
    before = torch.get_float32_matmul_precision()
    stack_before = len(torch.overrides._get_current_function_mode_stack())
    for precision in ("bfloat16", "high", "highest", None):
        res = TS.perform_inference(_logreg(BT, BFT), number_iterations=5, number_samples=2,
                                   device="cpu", key=0, matmul_precision=precision)
        assert np.isfinite(res.loss_curve).all()
        assert torch.get_float32_matmul_precision() == before
        assert len(torch.overrides._get_current_function_mode_stack()) == stack_before
    with TS.matmul_precision_scope("high"):
        assert torch.get_float32_matmul_precision() == "high"  # TF32 on a card
    with pytest.raises(RuntimeError, match="inside"):
        with TS.matmul_precision_scope("bfloat16"):
            raise RuntimeError("inside")
    assert torch.get_float32_matmul_precision() == before
    assert len(torch.overrides._get_current_function_mode_stack()) == stack_before
    with pytest.raises(ValueError, match="unknown matmul_precision"):
        TS.perform_inference(_logreg(BT, BFT), number_iterations=1, device="cpu",
                             matmul_precision="int8")


def test_jax_on_the_cpu_ignores_bfloat16():
    """JAX's loss under jax.default_matmul_precision("bfloat16") equals its
    f32 loss on this backend, and both equal the port's f32 loss at the same
    draws, not its bf16 one: here JAX cannot be the bf16 reference."""
    jc = _logreg(BJ, BFJ).compiled()
    jguide = JG.AutoMeanField(jc)
    jloss = JS.ReverseKL().make_loss(jc, jguide)
    jparams = {"p": dict(jc.initial_params), "q": jguide.init_params(jax.random.PRNGKey(1))}
    jparams["q"]["loc"] = jparams["q"]["loc"] + 0.5
    key = jax.random.PRNGKey(5)

    def loss_at(p, precision):
        if precision is None:
            return jloss(p, key, S)
        with jax.default_matmul_precision(precision):
            return jloss(p, key, S)

    j32 = float(jax.jit(lambda p: loss_at(p, None))(jparams))
    j16 = float(jax.jit(lambda p: loss_at(p, "bfloat16"))(jparams))
    assert j16 == j32
    _, k_guide = jax.random.split(key)
    eps = torch.as_tensor(np.stack([np.asarray(jax.random.normal(k, (jguide.dim,)))
                                    for k in jax.random.split(k_guide, S)]))
    tc = _logreg(BT, BFT).compiled("cpu")
    tloss = TS.ReverseKL().make_loss(tc, TG.AutoMeanField(tc))
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    with torch.no_grad():
        t32 = float(tloss(tparams, None, S, draws={"noise": eps}))
        with TS.matmul_precision_scope("bfloat16"):
            t16 = float(tloss(tparams, None, S, draws={"noise": eps}))
    np.testing.assert_allclose(t32, j32, rtol=1e-5)
    assert abs(t16 - j16) > 3e-5 * abs(j16)
