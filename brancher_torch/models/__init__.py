"""Model families shared by tests and ``chip_smoke.py``.

Counterpart of ``brancher_tpu/models``: conjugate, logistic regression,
AR(p) series, the linear-Gaussian state-space model and the VAE.
"""

from .autoregressive import ar1_stationary_stats, ar_model, make_ar_data
from .conjugate import conjugate_normal_model
from .logistic_regression import logistic_regression_model, make_logreg_data
from .state_space import (
    LGSSMParams,
    kalman_filter,
    lgssm_model,
    lgssm_state_space,
    make_lgssm_data,
)
from .vae import VAEConfig, make_vae_data, vae_model
