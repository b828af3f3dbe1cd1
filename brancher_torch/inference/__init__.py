"""Inference engines ported so far: vectorized NUTS, chain-batched HMC
and ChEES, and their diagnostics.

Counterpart of ``brancher_tpu/inference``.  SVI, SMC and the per-chain
engines are still to port (ROADMAP queue 1, items 10-12).
"""

from .chees import ChEESHMC, ChEESResult, chees_hmc
from .diagnostics import (
    effective_sample_size,
    folded_rhat,
    max_rhat,
    potential_scale_reduction,
    rank_normalized_rhat,
)
from .hmc import HMC, hmc_sample
from .mcmc import MCMCResult, sample
from .nuts import NUTS
