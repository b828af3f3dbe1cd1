"""Eight schools (hierarchical Gaussian, non-centered parameterization).

The classic partial-pooling benchmark: school effects theta_i share a
population mean/scale.  The non-centered form theta = mu + tau * theta_raw
is the geometry NUTS needs, expressed directly with DSL arithmetic.

The port of ``examples/07_eight_schools.py`` to brancher_torch, at its
sizes and seed (no kernel: the recognizer declines a hierarchy).

Run from the repository root:  PYTHONPATH=. python3 examples/torch/07_eight_schools.py
"""
import numpy as np

from brancher_torch import (DeterministicVariable, HalfCauchyVariable, NormalVariable,
                            ProbabilisticModel)
from brancher_torch.inference import NUTS, sample

Y_OBS = np.asarray([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], np.float32)
SIGMA = np.asarray([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], np.float32)
# Stan's reference posterior: mu 4.4 +- 3.3, tau 3.6 +- 3.2
STAN_MU, STAN_TAU = 4.4, 3.6


def eight_schools_model():
    mu = NormalVariable(0.0, 5.0, "mu")
    tau = HalfCauchyVariable(5.0, "tau")
    theta_raw = NormalVariable(np.zeros(8, np.float32), np.ones(8, np.float32), "theta_raw")
    theta = DeterministicVariable(mu + tau * theta_raw, "theta")  # non-centered
    y = NormalVariable(theta, SIGMA, "y")
    y.observe(Y_OBS)
    return ProbabilisticModel([y])


def main(device="cuda", num_samples=1000, num_warmup=1000, num_chains=16, max_depth=8,
         key=0) -> dict:
    res = sample(eight_schools_model(), kernel=NUTS(max_depth=max_depth),
                 num_samples=num_samples, num_warmup=num_warmup, num_chains=num_chains,
                 key=key, device=device)
    mu_s, tau_s = res.samples["mu"], res.samples["tau"]
    return {
        "mu_mean": float(mu_s.mean()), "mu_sd": float(mu_s.std()),
        "tau_mean": float(tau_s.mean()), "tau_sd": float(tau_s.std()),
        "mu_ess": float(res.diagnostics["ess"]["mu"]),
        "tau_ess": float(res.diagnostics["ess"]["tau"]),
        "num_divergences": res.diagnostics["num_divergences"],
        "r_hat_mu": float(res.diagnostics["r_hat"]["mu"]),
        "theta_mean": res.samples["theta"].mean(dim=(0, 1)).cpu().numpy(),
        "fused_family": res.diagnostics["fused_family"],
    }


if __name__ == "__main__":
    out = main()
    print(f"mu:  {out['mu_mean']:.2f} ± {out['mu_sd']:.2f}   (Stan ref ≈ 4.4 ± 3.3)")
    print(f"tau: {out['tau_mean']:.2f} ± {out['tau_sd']:.2f}  (Stan ref ≈ 3.6 ± 3.2)")
    print(f"divergences: {out['num_divergences']}, r_hat(mu) = {out['r_hat_mu']:.4f}")
    print("per-school effects:", out["theta_mean"].round(1))
