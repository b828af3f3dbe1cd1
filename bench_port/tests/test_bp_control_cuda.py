"""On the card: at the covtype shape the control, the reference in TF32 put
in the program's place, fails the potential's check that the program (K1,
f32) passes; so does the program's own bf16 path (K2)."""
import pytest

from bench_port.tests.bp_tiny import TINY


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(card):
    from bench_port import harness

    cell = harness.Cell(harness.load_benchmark(), "covtype_logreg.nuts_c64")
    cell.wl = dict(cell.wl, **TINY)
    out = harness.run_cell(cell, 2**31 + 3, 2.0, False, card, controls=True)
    limit = cell.wl["limits"]["grad_err"]
    assert out["numbers"]["grad_err"] <= limit
    assert out["controls"]["tf32_reference"]["grad_err"] > limit
    assert out["controls"]["program_bf16"]["grad_err"] > limit
