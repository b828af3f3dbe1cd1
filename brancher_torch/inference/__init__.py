"""Inference engines: SVI and point estimation, Wasserstein and Stein
variational gradient descent (``particle_inference_tools``), vectorized
NUTS (lockstep or draw-pipelined), chain-batched HMC and ChEES, the
per-chain NUTS and HMC steps of ``chain_method="vmap"``, dense mass and
resumed runs, their diagnostics, and the single-device particle methods
(the bootstrap and streaming filters, tempered SMC, PMMH and particle
Gibbs), and their sharded modes over a ``DeviceMesh`` (``mesh=``: chains,
SVI batches, particle filters, streaming SMC and PMMH; the SPMD convention
of ``parallel/mesh.py``).

Counterpart of ``brancher_tpu/inference``.
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
from .nuts import NUTS, nuts_sample
from .particle_gibbs import PGResult, particle_gibbs_sample
from .pmmh import PMMHResult, pmmh_sample
from .smc import SMCResult, smc_sample
from .streaming_smc import StreamingResult, StreamingSMC, streaming_particle_filter
from .particle_inference_tools import run_svgd, run_wvgd
from .tempered_smc import TemperedSMCResult, smc_posterior_sample, tempered_smc
