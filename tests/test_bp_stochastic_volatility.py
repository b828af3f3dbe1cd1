"""The benchmark's stochastic-volatility configuration on the CPU at a small
T: the port's autodiff value+grad against the plain float64 reference
(``bench_port/configs/stochastic_volatility_ref.py``), the constrained
draws mapped back to the unconstrained states, the reduced-precision
control, the reader of the tree's state, and a tiny run of the cell through
the harness, with its chains frozen and without."""
import math

import pytest
import torch

import brancher_torch.inference.mcmc as mcmc
from bench_port import check, harness
from bench_port.tests.bp_tiny import tiny_cell

CELL = "stochastic_volatility.nuts_c1024"
ROWS = 50


@pytest.fixture(scope="module")
def setup():
    cell = tiny_cell(CELL, rows=ROWS)
    data = cell.model.make_data(cell.cfg, 11, "cpu")
    comp = cell.model.build_model(cell.cfg, data).compiled("cpu")
    return cell, data, comp


def _states(comp, n=6, seed=4):
    """n unconstrained states near the posterior's scale: log sigma about
    log 0.05, log nu about log 10, a walk of steps about 0.05."""
    g = torch.Generator().manual_seed(seed)
    parts = {"sigma": -3.0 + 0.3 * torch.randn(n, generator=g),
             "nu": 2.3 + 0.3 * torch.randn(n, generator=g),
             "s": torch.cumsum(0.05 * torch.randn(n, ROWS, generator=g), -1)}
    order = comp.unravel_z(torch.zeros(1, comp.dim))
    return torch.cat([parts[k].reshape(n, -1) for k in order], -1)


def test_the_model_has_t_plus_two_latents(setup):
    cell, data, comp = setup
    assert comp.dim == ROWS + 2 and data["r"].shape == (ROWS,)
    assert cell.ref.prepare(cell.cfg, data, "f64")["x_t"].shape == (1, ROWS)
    full = harness.Cell(harness.load_benchmark(), CELL)
    assert full.cfg["num_rows"] == 3000 and full.cfg["reduced"] == []
    w = full.model.work(full.cfg, 1024, 3002)
    assert w["bytes"] == 4 * (2 * 1024 * 3002 + 1024 + 3000) and w["dtype"] == "f32"


@pytest.mark.parametrize("seed", [4, 5])
def test_reference_matches_the_port(setup, seed):
    from brancher_torch.inference.hmc import autodiff_value_and_grad
    from brancher_torch.inference.mcmc import make_potential

    cell, data, comp = setup
    z = _states(comp, seed=seed)
    v, g = autodiff_value_and_grad(make_potential(comp, comp.initial_params)[0])(z)
    ref = [cell.ref.value_and_grad(cell.ref.prepare(cell.cfg, data, "f64"), comp.unravel_z(z))]
    nums = check.potential_numbers([(v, comp.unravel_z(g))], ref, cell.ref.LATENTS)
    assert nums["grad_err"] < 1e-5 and nums["value_err"] < 1e-3, nums


def test_constrained_draws_map_back_to_the_same_states(setup):
    cell, _, comp = setup
    z = _states(comp)
    vals = torch.func.vmap(lambda zf: comp.constrain(comp.initial_params, comp.unravel_z(zf)))(z)
    assert (vals["sigma"] > 0).all() and (vals["nu"] > 0).all()
    back = check.flat(cell.ref.to_unconstrained(vals), cell.ref.LATENTS, 1)
    assert torch.allclose(back, check.flat(comp.unravel_z(z), cell.ref.LATENTS, 1), atol=1e-5)


def test_the_control_reads_far_from_float64_where_float32_does_not(setup):
    cell, data, comp = setup
    unravel = comp.unravel_z(_states(comp))
    ref = [cell.ref.value_and_grad(cell.ref.prepare(cell.cfg, data, "f64"), unravel)]

    def numbers(precision):
        low = cell.ref.value_and_grad(cell.ref.prepare(cell.cfg, data, precision), unravel)
        return check.potential_numbers([low], ref, cell.ref.LATENTS)

    f32, tf32, bf16 = numbers("f32"), numbers("tf32"), numbers("bf16")
    assert f32["grad_err"] < 1e-5 and f32["value_err"] < 1e-3, f32
    assert bf16["grad_err"] > 100 * f32["grad_err"] and bf16["value_err"] > 100 * f32["value_err"]
    assert tf32["grad_err"] > 10 * f32["grad_err"], tf32


def test_tree_state_reader_reads_bytes_a_transition():
    reader = harness.load_module(harness.reader_path("tree_state_mb"), "t_tree_state_mb")
    per_tree = 37 * 1024 * 3002 * 4
    draws = {"tree_state_bytes": 10 * per_tree, "depth_hist": [0] * 8 + [10 * 1024]}
    assert reader.read({"chains": 1024, "spans": {"draws": draws}}) == pytest.approx(per_tree / 1e6)
    for ctx in ({"chains": 1024}, {"chains": 1024, "spans": None},
                {"chains": 1024, "spans": {"draws": dict(draws, tree_state_bytes=None)}}):
        assert reader.read(ctx) is None


def _unchanged(monkeypatch):
    """The engine returns its start state as each draw."""
    real = mcmc.nuts_batched

    def frozen_engine(vg, z0, *args, **kw):
        res = real(vg, z0, *args, **kw)
        return res._replace(samples=z0[:, None, :].expand_as(res.samples).clone())

    monkeypatch.setattr(mcmc, "nuts_batched", frozen_engine)


@pytest.mark.parametrize("fault", [None, "unchanged"])
def test_a_tiny_run_checks_the_potential_and_fails_frozen_chains(monkeypatch, fault):
    """A tiny run of the cell through the harness (trees to depth 5, for
    time): the potential's numbers
    at the window's states pass the cell's limits and the draws' numbers
    are finite; frozen chains turn ``correct`` false by R-hat.  (The draws'
    limits are not held here: at a T and a budget a CPU run holds, 10 to
    400 steps and 8 to 64 chains after 60 to 300 warmup iterations, the
    centred walk's funnel keeps sigma's chains apart, split R-hat 1.7 to 7.)"""
    cell = tiny_cell(CELL, rows=ROWS)
    cell.wl = dict(cell.wl, kernel_args=dict(cell.wl["kernel_args"], max_depth=5))
    plant = None if fault is None else (lambda: _unchanged(monkeypatch))
    out = harness.run_cell(cell, 2**31 + 77, 1.0, False, "cpu", after_setup=plant)
    checks = out["line"]["checks"]
    for name in ("grad_err", "value_err"):
        assert checks[name]["value"] <= checks[name]["limit"], checks
    if fault is None:
        assert all(math.isfinite(c["value"]) for c in checks.values()), checks
        assert out["line"]["failed"] == 0
    else:
        assert out["line"]["correct"] is False
        assert not checks["rhat_max"]["value"] <= checks["rhat_max"]["limit"], checks
