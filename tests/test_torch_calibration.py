"""Simulation-based calibration (SBC) of the port's engines: the
counterpart of ``tests/test_calibration.py``, at its sizes.

Each vectorized 'chain' carries its own synthetic dataset drawn from the
prior predictive; the posterior ranks of the true parameter among the
thinned draws must be uniform (chi-square p > ``P_MIN``, JAX's limit).
Three engines: vectorized NUTS (``nuts_batched``) on a conjugate target,
ChEES (``chees_hmc``) on the same target, and NUTS on the non-centered
hierarchy shape the ARD headline samples.

The per-rep datasets and start points are made with numpy from the seed;
the engines draw from a ``torch.Generator`` with the same seed.  The seeds
were fixed before the first run, and every one must pass: 0, 1 and 2 for
each engine.  The conjugate NUTS and ChEES cases run in the fast gate
(one to two seconds a seed on a CPU); the hierarchy (about 40 s a seed:
autograd at up to 256 leaves a draw) is ``slow``, as all three of JAX's
are.
"""
import numpy as np
import pytest
import scipy.stats as st
import torch

from brancher_torch.inference.chees import chees_hmc
from brancher_torch.inference.vectorized_nuts import nuts_batched

P_MIN = 0.005
SEEDS = (0, 1, 2)
REPS, N_OBS = 128, 10
PRIOR_SCALE, LIK_SCALE = 2.0, 1.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these runs are many small operations, which
    threads only slow down when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rank_uniformity_pval(thinned, truth):
    """chi-square p-value of SBC ranks of ``truth`` [reps] among
    ``thinned`` [reps, n_draws]."""
    n_draws = thinned.shape[1]
    ranks = (thinned < truth[:, None]).sum(1)
    counts = np.bincount(ranks.numpy(), minlength=n_draws + 1)
    return st.chisquare(counts)[1], counts


def _conjugate(seed):
    """(mu_true [reps], data [reps, n_obs], value+grad, z0 [reps, 1])."""
    rs = np.random.RandomState(seed)
    mu_true = PRIOR_SCALE * rs.normal(size=REPS)
    data = mu_true[:, None] + LIK_SCALE * rs.normal(size=(REPS, N_OBS))
    z0 = PRIOR_SCALE * rs.normal(size=(REPS, 1))
    d = torch.as_tensor(data, dtype=torch.float32)

    def vg(z):  # z: [reps, 1]; each rep's dataset baked into its potential
        mu = z[:, 0]
        lp = -0.5 * (mu / PRIOR_SCALE) ** 2
        ll = -0.5 * torch.sum((d - mu[:, None]) ** 2, -1) / LIK_SCALE**2
        grad = -mu / PRIOR_SCALE**2 + torch.sum(d - mu[:, None], -1) / LIK_SCALE**2
        return lp + ll, grad[:, None]

    return (torch.as_tensor(mu_true, dtype=torch.float32), data, vg,
            torch.as_tensor(z0, dtype=torch.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_sbc_ranks_uniform(seed):
    mu_true, data, vg, z0 = _conjugate(seed)
    res = nuts_batched(vg, z0, num_warmup=300, num_samples=255,
                       generator=torch.Generator().manual_seed(seed), max_depth=6)
    draws = res.samples[:, :, 0]  # [reps, 255]
    # thinned to ~independent draws, so that the rank distribution is exact
    pval, counts = _rank_uniformity_pval(draws[:, ::8], mu_true)  # 32 draws a rep
    assert pval > P_MIN, (pval, counts)
    # and the posterior mean tracks each rep's closed-form mean
    post_var = 1.0 / (1 / PRIOR_SCALE**2 + N_OBS / LIK_SCALE**2)
    analytic = post_var * data.sum(-1) / LIK_SCALE**2
    err = np.abs(draws.mean(-1).numpy() - analytic)
    assert np.median(err) < 3 * np.sqrt(post_var / 32), np.median(err)


@pytest.mark.parametrize("seed", SEEDS)
def test_sbc_ranks_uniform_chees(seed):
    """ChEES's shared trajectory and step adaptation couples the chains'
    kernels, but each chain's accept test still targets its own per-rep
    posterior: calibrated, with no divergence."""
    mu_true, _, vg, z0 = _conjugate(seed)
    res = chees_hmc(vg, z0, num_warmup=400, num_samples=255,
                    generator=torch.Generator().manual_seed(seed))
    pval, counts = _rank_uniformity_pval(res.samples[:, ::8, 0], mu_true)
    assert pval > P_MIN, (pval, counts)
    assert int(res.diverging.sum()) == 0


@pytest.mark.slow
@pytest.mark.parametrize("seed", SEEDS)
def test_sbc_ranks_uniform_noncentered_hierarchy(seed):
    """tau ~ LogNormal(0, s), theta = tau * raw with raw ~ N(0, I_J), y_jn
    ~ N(theta_j, sigma); ranks for both the scale (u = log tau, the funnel
    axis) and one centered coordinate theta_1."""
    j_n, n_obs, s_tau, sigma = 4, 5, 0.75, 1.0
    rs = np.random.RandomState(seed)
    u_true = s_tau * rs.normal(size=REPS)
    raw_true = rs.normal(size=(REPS, j_n))
    theta_true = np.exp(u_true)[:, None] * raw_true
    data = torch.as_tensor(theta_true[:, :, None] + sigma * rs.normal(size=(REPS, j_n, n_obs)),
                           dtype=torch.float32)
    z0 = torch.as_tensor(0.1 * rs.normal(size=(REPS, 1 + j_n)), dtype=torch.float32)

    def logp_all(z):  # [reps, 1 + J] = (u, raw)
        u, raw = z[:, 0], z[:, 1:]
        theta = torch.exp(u)[:, None] * raw
        lp = -0.5 * (u / s_tau) ** 2 - 0.5 * torch.sum(raw**2, -1)
        ll = -0.5 * torch.sum((data - theta[:, :, None]) ** 2, (-1, -2)) / sigma**2
        return lp + ll

    def vg(z):  # rows are independent, so the gradient of the sum is each row's
        with torch.enable_grad():
            zg = z.detach().requires_grad_(True)
            val = logp_all(zg)
            grad, = torch.autograd.grad(val.sum(), zg)
        return val.detach(), grad

    res = nuts_batched(vg, z0, num_warmup=500, num_samples=511,
                       generator=torch.Generator().manual_seed(seed), max_depth=8,
                       target_accept=0.9)
    thin = res.samples[:, ::16]  # 32 draws a rep
    pval_u, counts_u = _rank_uniformity_pval(thin[:, :, 0], torch.as_tensor(u_true))
    assert pval_u > P_MIN, (pval_u, counts_u)
    theta1 = torch.exp(thin[:, :, 0]) * thin[:, :, 1]
    pval_t, counts_t = _rank_uniformity_pval(theta1, torch.as_tensor(theta_true[:, 0]))
    assert pval_t > P_MIN, (pval_t, counts_t)
