"""Linear-Gaussian state-space model: particle filter vs exact Kalman.

The port of ``examples/04_state_space_smc.py`` to brancher_torch, at its
sizes and seed (no kernel: the bootstrap filter is plain PyTorch on the
card).

Run from the repository root:  PYTHONPATH=. python3 examples/torch/04_state_space_smc.py
"""
import numpy as np

from brancher_torch.inference.smc import smc_sample
from brancher_torch.models.state_space import (
    LGSSMParams,
    kalman_filter,
    lgssm_state_space,
    make_lgssm_data,
)

PARAMS = LGSSMParams(a=0.9, q=0.3, c=1.0, r=0.5)


def main(device="cuda", length=200, num_particles=8192, key=0) -> dict:
    _, ys = make_lgssm_data(length=length, params=PARAMS)
    res = smc_sample(lgssm_state_space(PARAMS), ys, num_particles=num_particles, key=key,
                     device=device)
    ll_exact, means_exact, _ = kalman_filter(ys, PARAMS)
    return {
        "smc_log_marginal": float(res.log_marginal),
        "kalman_log_marginal": float(ll_exact),
        "max_filter_mean_error": float(np.max(np.abs(
            res.filter_means.cpu().numpy() - np.asarray(means_exact)))),
        "min_ess": float(res.ess_history.min()),
    }


if __name__ == "__main__":
    out = main()
    print(f"SMC    log marginal: {out['smc_log_marginal']:.3f}")
    print(f"Kalman log marginal: {out['kalman_log_marginal']:.3f}")
    print("max |filter mean error|:", out["max_filter_mean_error"])
    print("min ESS over time:", out["min_ess"])
