"""Port parity: inference with enumerated discrete latents
(``sample(enumerate_discrete=True)`` and ``ReverseKL(enumerate_discrete=True)``
of brancher_torch against brancher_tpu's).

The fixed-draw ELBO and its gradients are held to JAX's within
1e-4 * max(1, |value|); short CPU runs of every engine check what the
samples hold and that the GLM recognizer is not asked; whole NUTS runs
are held to their JAX tests' limits and marked slow, as JAX marks its
own.  The models are those of ``test_torch_enumeration.py``."""
import jax
import numpy as np
import pytest
import torch

import brancher_torch as BT
import brancher_torch.functions as BFT
from brancher_torch.bridge import params_to_torch
from brancher_torch.inference import ChEESHMC, HMC, NUTS, sample
import brancher_torch.inference.guides as TG
import brancher_torch.inference.svi as TS
import brancher_tpu.inference.guides as JG
import brancher_tpu.inference.svi as JS
from test_torch_enumeration import (
    TOL,
    _chain_hmm_model,
    _close,
    _make_chain_data,
    _make_mixture_data,
    _mixture_model,
)

torch.set_num_threads(2)


def _mixture_with_descendant(n=40):
    data, comp = _make_mixture_data(n, 0)
    mu = BT.NormalVariable(np.zeros(2, np.float32), 3.0 * np.ones(2, np.float32), "mu")
    z = BT.CategoricalVariable(probs=np.ones(2, np.float32) / 2, name="z", plate_shape=(n,))
    doubled = BT.DeterministicVariable(2 * z, "doubled")
    spread = BT.DeterministicVariable(mu[1] - mu[0], "spread")
    x = BT.NormalVariable(BFT.take(mu, z), 0.5, "x")
    x.observe(data)
    return BT.ProbabilisticModel([x, doubled, spread])


@pytest.mark.parametrize("kernel,chain_method", [
    (NUTS(max_depth=6), "vectorized"), (HMC(num_integration_steps=8), "vectorized"),
    (ChEESHMC(max_leapfrog=16), "vectorized"), (NUTS(max_depth=6), "vmap"),
], ids=["nuts", "hmc", "chees", "nuts_vmap"])
def test_enumerated_sample_on_the_cpu(kernel, chain_method, monkeypatch):
    """sample(enumerate_discrete=True): samples hold the continuous latents
    and the deterministic nodes (the discrete ones pinned to 0 for their
    descendants), the GLM recognizer is never asked, and the component
    means land near +-2."""
    import brancher_torch.ops.glm as G

    def boom(*a, **k):
        raise AssertionError("the recognizer was called")

    monkeypatch.setattr(G, "recognize_fused_family", boom)
    model = _mixture_with_descendant()
    res = sample(model, kernel=kernel, chain_method=chain_method, num_samples=100,
                 num_warmup=100, num_chains=4, key=0, device="cpu", enumerate_discrete=True)
    assert set(res.samples) == {"mu", "doubled", "spread"}
    assert torch.all(res.samples["doubled"] == 0)
    assert res.diagnostics["fused_family"] is None
    mu = np.sort(res.samples["mu"].numpy().reshape(-1, 2), axis=1).mean(0)
    np.testing.assert_allclose(mu, [-2.0, 2.0], atol=0.4)
    np.testing.assert_allclose(res.samples["spread"].numpy(),
                               (res.samples["mu"][..., 1] - res.samples["mu"][..., 0]).numpy())


def _jax_guide_noise(key, dim, n):
    _k_data, k_guide = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(k, (dim,))) for k in jax.random.split(k_guide, n)])


@pytest.mark.parametrize("make", [
    lambda pkg: _mixture_model(pkg, _make_mixture_data(10, 2)[0]),
    lambda pkg: _chain_hmm_model(pkg, _make_chain_data(5)),
], ids=["mixture", "chain"])
def test_enumerated_reverse_kl_fixed_draw_loss_and_grads_match_jax(make):
    """ReverseKL(enumerate_discrete=True) with the mean-field guide: the
    loss and its gradients at JAX's guide noise equal JAX's."""
    jc, tc = make("jax").compiled(), make("torch").compiled("cpu")
    jg, tg = JG.AutoMeanField(jc), TG.AutoMeanField(tc)
    jloss = JS.ReverseKL(enumerate_discrete=True).make_loss(jc, jg)
    tloss = TS.ReverseKL(enumerate_discrete=True).make_loss(tc, tg)
    rng = np.random.RandomState(4)
    q = jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.3 * rng.normal(
        size=np.shape(a)).astype(np.float32), jg.init_params(jax.random.PRNGKey(1)))
    jparams = {"p": dict(jc.initial_params), "q": q}
    key, n = jax.random.PRNGKey(3), 4
    ref_loss, ref_grad = jax.jit(jax.value_and_grad(jloss), static_argnums=2)(jparams, key, n)
    tparams = params_to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = [tparams["q"][k].requires_grad_(True) for k in sorted(tparams["q"])]
    noise = torch.as_tensor(_jax_guide_noise(key, jg.dim, n))
    loss = tloss(tparams, None, n, draws={"data": {}, "noise": noise})
    _close(float(loss), float(ref_loss), TOL, "loss")
    grads = torch.autograd.grad(loss, leaves)
    for k, g in zip(sorted(tparams["q"]), grads):
        _close(g.numpy(), np.asarray(ref_grad["q"][k]), TOL, f"d loss / d {k}")


@pytest.mark.slow
def test_enumerated_nuts_mixture_matches_jax_within_mc_error():
    """JAX's test_enumerated_nuts_mixture_assignments on both packages: the
    port's sorted component means within its limits and within 5 MC
    standard errors of JAX's run, and the responsibilities at the ordered
    posterior mean classify the points."""
    import brancher_tpu.inference as JI
    from brancher_torch.inference.diagnostics import effective_sample_size

    data, true_comp = _make_mixture_data(40, 0)
    model = _mixture_model("torch", data)
    kw = dict(num_samples=400, num_warmup=400, num_chains=4, enumerate_discrete=True)
    res = sample(model, kernel=NUTS(max_depth=8), key=0, device="cpu", **kw)
    ref = JI.sample(_mixture_model("jax", data), kernel=JI.NUTS(max_depth=8),
                    key=jax.random.PRNGKey(0), **kw)
    draws = [np.sort(np.asarray(r.samples["mu"], np.float64), axis=-1) for r in (res, ref)]
    means = [d.reshape(-1, 2).mean(0) for d in draws]
    se = [d.reshape(-1, 2).std(0) / np.sqrt(effective_sample_size(d)) for d in draws]
    assert np.all(np.abs(means[0] - means[1]) < 5 * np.hypot(se[0], se[1])), (means, se)
    mu_sorted = means[0]
    np.testing.assert_allclose(mu_sorted, [-2.0, 2.0], atol=0.2)
    comp = model.compiled("cpu")
    _, resp = comp.enumerated_log_density(comp.initial_params,
                                          {"mu": torch.as_tensor(mu_sorted)},
                                          return_responsibilities=True)
    hard = resp["z"].argmax(-1).numpy()
    assert max((hard == true_comp).mean(), (1 - hard == true_comp).mean()) > 0.95


@pytest.mark.slow
def test_enumerated_nuts_sequence_hmm_recovers_emissions():
    """JAX's test_sequence_enum_nuts_recovers_emissions (T=500, K=2, 4
    chains, 200 + 200) on the port, with its limit."""
    from brancher_torch.distributions import Categorical
    from brancher_torch.stochastic_processes import MarkovProcess

    t_len, k = 500, 2
    rng = np.random.RandomState(3)
    lt_np = np.asarray([[2.0, -2.0], [-2.0, 2.0]], np.float32)
    states = [0]
    for _ in range(t_len - 1):
        p = np.exp(lt_np[states[-1]]) / np.exp(lt_np[states[-1]]).sum()
        states.append(rng.choice(k, p=p))
    true_locs = np.asarray([-1.5, 1.5], np.float32)
    data = (true_locs[np.asarray(states)] + 0.5 * rng.normal(size=t_len)).astype(np.float32)
    lt = torch.as_tensor(lt_np)
    s = MarkovProcess(t_len, Categorical(), lambda prev: {"logits": lt[prev]},
                      init_dist=Categorical(), init_links={"logits": np.zeros(k, np.float32)},
                      name="s")
    locs = BT.NormalVariable(np.zeros(k, np.float32), 2.0 * np.ones(k, np.float32), "locs")
    y = BT.NormalVariable(BFT.take(locs, s), 0.5, "y")
    y.observe(data)
    res = sample(BT.ProbabilisticModel([y]), num_samples=200, num_warmup=200, num_chains=4,
                 key=0, device="cpu", enumerate_discrete=True)
    per_chain = np.sort(res.samples["locs"].numpy().mean(axis=1), axis=-1)
    np.testing.assert_allclose(per_chain.mean(axis=0), np.sort(true_locs), atol=0.25)
