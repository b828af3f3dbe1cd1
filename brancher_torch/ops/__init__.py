"""Fused potentials and their hand-written CUDA kernels (``../csrc``).

Counterpart of ``brancher_tpu/ops``.  Ported: the fused GLM value+grad
(``glm.py``, kernels K1-K4), the fused leapfrog (``leapfrog.py``, K5),
the whole-X logistic-regression value+grad (``logreg.py``, K6) and the
chain-batched HMC engine (``batched_hmc.py``).  ``resampling`` is still
to port (ROADMAP queue 1, item 11).  Importing builds nothing.
"""

from .glm import KERNELS, FusedFamily, build_glm_vg, kernel_for, recognize_fused_family
from .leapfrog import LEAPFROG, build_fused_leapfrog, reference_leapfrog
from .logreg import (
    LOGREG,
    logreg_value_and_grad,
    logreg_value_and_grad_reference,
    make_logreg_log_posterior,
)


def kernel_wrappers():
    """Every hand-written kernel's wrapper by name (K1-K6), each with its
    ``launches`` counter, ``source`` and the TPU kernel it ``replaces``."""
    return {**KERNELS, LEAPFROG.name: LEAPFROG, LOGREG.name: LOGREG}
