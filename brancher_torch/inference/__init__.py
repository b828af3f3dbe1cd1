"""Inference engines ported so far: SVI and point estimation, vectorized
NUTS, chain-batched HMC and ChEES, and their diagnostics.

Counterpart of ``brancher_tpu/inference``.  SMC, the per-chain engines
and the particle methods are still to port (ROADMAP queue 1, items 11,
12 and 14).
"""

from .svi import (
    MAP,
    MaximumLikelihood,
    ReverseKL,
    SteinVariationalGradientDescent,
    WassersteinVariationalGradientDescent,
    perform_inference,
)
from .gradient_estimators import (
    BlackBoxEstimator,
    PathwiseDerivativeEstimator,
    Taylor1Estimator,
)
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
