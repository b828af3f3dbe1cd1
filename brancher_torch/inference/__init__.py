"""Inference engines ported so far: vectorized NUTS and its diagnostics.

Counterpart of ``brancher_tpu/inference``.  SVI, HMC/ChEES, SMC and the
per-chain engines are still to port (ROADMAP queue 1, items 9-12).
"""

from .diagnostics import (
    effective_sample_size,
    folded_rhat,
    max_rhat,
    potential_scale_reduction,
    rank_normalized_rhat,
)
from .mcmc import MCMCResult, sample
from .nuts import NUTS
