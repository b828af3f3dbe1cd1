"""Model families shared by tests and ``chip_smoke.py``.

Counterpart of ``brancher_tpu/models``.  Ported so far: conjugate,
logistic regression and the VAE; the autoregressive and state-space
families are still to port (ROADMAP queue 1, items 11 and 13).
"""

from .conjugate import conjugate_normal_model
from .logistic_regression import logistic_regression_model, make_logreg_data
from .vae import VAEConfig, make_vae_data, vae_model
