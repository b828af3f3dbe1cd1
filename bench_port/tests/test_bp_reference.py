"""The plain references against the port at a tiny size on the CPU: the
value (up to the constants the port may drop) and the gradient at random
unconstrained states, through the port's autodiff potential and, for the
GLM configuration, its fused family (the kernel's plain version here)."""
import pytest
import torch

from bench_port import check
from bench_port.tests.bp_tiny import tiny_cell


@pytest.mark.parametrize("name", ["covtype_logreg.nuts_c64", "german_credit_sparse.nuts_c1024"])
def test_reference_matches_the_port(name):
    from brancher_torch.inference.hmc import autodiff_value_and_grad
    from brancher_torch.inference.mcmc import make_potential
    from brancher_torch.ops.glm import recognize_fused_family

    cell = tiny_cell(name, rows=300)
    data = cell.model.make_data(cell.cfg, 11, "cpu")
    comp = cell.model.build_model(cell.cfg, data).compiled("cpu")
    z = 0.5 * torch.randn(6, comp.dim, generator=torch.Generator().manual_seed(4))
    vgs = [autodiff_value_and_grad(make_potential(comp, comp.initial_params)[0])]
    fam = recognize_fused_family(comp, comp.initial_params)
    assert (fam is not None) == (name.startswith("covtype"))
    if fam is not None:
        vgs.append(fam.value_and_grad("f32"))
    prep = cell.ref.prepare(cell.cfg, data, "f64")
    ref = [cell.ref.value_and_grad(prep, comp.unravel_z(z))]
    for vg in vgs:
        v, g = vg(z)
        nums = check.potential_numbers([(v, comp.unravel_z(g))], ref, cell.ref.LATENTS)
        assert nums["grad_err"] < 1e-5 and nums["value_err"] < 1e-3, nums
    # the constrained draws map back to the same unconstrained states
    vals = torch.func.vmap(lambda zf: comp.constrain(comp.initial_params, comp.unravel_z(zf)))(z)
    back = check.flat(cell.ref.to_unconstrained(vals), cell.ref.LATENTS, 1)
    assert torch.allclose(back, check.flat(comp.unravel_z(z), cell.ref.LATENTS, 1), atol=1e-5)
    # the control's precision reads far from float64 where float32 does not
    low = cell.ref.prepare(cell.cfg, data, "tf32")
    lows = check.potential_numbers([cell.ref.value_and_grad(low, comp.unravel_z(z))], ref,
                                   cell.ref.LATENTS)
    assert lows["grad_err"] > 1e-4
