"""Runs with the timed path broken underneath, after set-up, at a tiny size
on the CPU: each of the faults a cell of this benchmark can have turns
``correct`` false through the number meant to catch it.  (One chip: no
exchange between chips to leave out.)"""
import pytest
import torch

import brancher_torch.distributions as dists
import brancher_torch.inference.mcmc as mcmc
import brancher_torch.ops.glm as glm
from bench_port.tests.bp_tiny import tiny_run

CELLS = ["covtype_logreg.nuts_c64", "german_credit_sparse.nuts_c1024"]


def _unchanged(monkeypatch):
    """The cells' engine returns its start state as each draw."""
    real = mcmc.nuts_batched

    def frozen_engine(vg, z0, *args, **kw):
        res = real(vg, z0, *args, **kw)
        return res._replace(samples=z0[:, None, :].expand_as(res.samples).clone())

    monkeypatch.setattr(mcmc, "nuts_batched", frozen_engine)


def _half_rows(monkeypatch):
    """The likelihood over every other row, doubled: half of the rows left
    out, the mean taken over the rest (the fused family's plain version,
    and the Bernoulli density the autodiff potential sums)."""
    real_vg, real_lp = glm.bernoulli_vg_reference, dists.Bernoulli.log_prob

    def vg(z, x, y, b, prior_mean, prior_inv_var, ll_scale=1.0):
        return real_vg(z, x[::2], y[::2], b[::2], prior_mean, prior_inv_var, 2.0 * ll_scale)

    def lp(self, value, **kw):
        out = real_lp(self, value, **kw)
        keep = (torch.arange(out.shape[-1], device=out.device) % 2 == 0).to(out.dtype)
        return 2.0 * keep * out

    monkeypatch.setattr(glm, "bernoulli_vg_reference", vg)
    monkeypatch.setattr(dists.Bernoulli, "log_prob", lp)


def _altered(monkeypatch):
    """The potential's answer altered where it is produced: one gradient
    coordinate 1 % off in the fused family, the logits' density tilted in
    the autodiff one."""
    real_vg, real_lp = glm.bernoulli_vg_reference, dists.Bernoulli.log_prob

    def vg(*args, **kw):
        v, g = real_vg(*args, **kw)
        g = g.clone()
        g[:, 0] *= 1.01
        return v, g

    def lp(self, value, probs=None, logits=None):
        return real_lp(self, value, probs=probs, logits=logits) + 0.01 * logits

    monkeypatch.setattr(glm, "bernoulli_vg_reference", vg)
    monkeypatch.setattr(dists.Bernoulli, "log_prob", lp)


FAULTS = {"unchanged": (_unchanged, "rhat_max"), "half_rows": (_half_rows, "grad_err"),
          "altered": (_altered, "grad_err")}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_turns_correct_false(monkeypatch, cell, fault):
    plant, number = FAULTS[fault]
    out = tiny_run(cell, after_setup=lambda: plant(monkeypatch))
    checks = out["line"]["checks"]
    assert out["line"]["correct"] is False
    assert not checks[number]["value"] <= checks[number]["limit"], checks


@pytest.mark.parametrize("cell", CELLS)
def test_controls_and_planted_faults_fail_their_numbers(cell):
    """The control (the reference in TF32, and bf16, in the program's place;
    the program's own bf16 path where it has one) fails the gradient's
    limit, and faults planted in the draws fail the draws' limits."""
    from bench_port import harness
    from bench_port.tests.bp_tiny import tiny_cell

    c = tiny_cell(cell)
    out = harness.run_cell(c, 2**31 + 99, 1.0, False, "cpu", controls=True)
    lim = c.wl["limits"]
    ctl = out["controls"]
    assert ctl["tf32_reference"]["grad_err"] > lim["grad_err"]
    assert ctl["bf16_reference"]["grad_err"] > lim["grad_err"]
    if cell.startswith("covtype"):
        assert ctl["program_bf16"]["grad_err"] > lim["grad_err"]
    assert ctl["draws_shifted"]["stein_shift"] > lim["stein_shift"]
    assert ctl["draws_widened"]["stein_scale"] > lim["stein_scale"]
    assert ctl["half_chains_unchanged"]["rhat_max"] > lim["rhat_max"]
