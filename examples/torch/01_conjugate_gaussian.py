"""Normal-Normal conjugate mean inference: SVI + NUTS vs closed form.

The port of ``examples/01_conjugate_gaussian.py`` to brancher_torch, at
its sizes and seed.  On the card NUTS runs the fused Normal-learned
value+grad kernel (K3: the recognizer finds x ~ N(mu, 1) is a GLM).

Run from the repository root:  PYTHONPATH=. python3 examples/torch/01_conjugate_gaussian.py
"""
import numpy as np

from brancher_torch import NormalVariable, ProbabilisticModel
from brancher_torch.inference import NUTS, perform_inference, sample


def main(device="cuda", num_obs=50, svi_iterations=2000, num_samples=1000, num_warmup=500,
         num_chains=8, key=0) -> dict:
    # ground truth data
    data = np.random.RandomState(0).normal(1.5, 1.0, size=num_obs).astype(np.float32)

    # model: mu ~ N(0, 2);  x_i ~ N(mu, 1)
    mu = NormalVariable(0.0, 2.0, "mu")
    x = NormalVariable(mu, 1.0, "x")
    x.observe(data)
    model = ProbabilisticModel([x])

    # closed-form posterior
    post_var = 1.0 / (1 / 4.0 + len(data))
    post_mean = post_var * data.sum()

    # mean-field SVI
    res = perform_inference(model, number_iterations=svi_iterations, number_samples=32,
                            lr=0.02, key=key, device=device)
    loc, var = res.guide.posterior_moments(res.params["q"])

    # NUTS
    mcmc = sample(model, kernel=NUTS(), num_samples=num_samples, num_warmup=num_warmup,
                  num_chains=num_chains, key=key, device=device)
    mu_s = mcmc.samples["mu"]
    return {
        "analytic_mean": float(post_mean), "analytic_var": float(post_var),
        "svi_mean": float(loc[0]), "svi_var": float(var[0]),
        "nuts_mean": float(mu_s.mean()), "nuts_var": float(mu_s.var()),
        "r_hat": float(mcmc.diagnostics["r_hat"]["mu"]),
        "min_ess": float(np.min(mcmc.diagnostics["ess"]["mu"])),
        "num_divergences": mcmc.diagnostics["num_divergences"],
        "fused_family": mcmc.diagnostics["fused_family"],
        "value_and_grad_calls": mcmc.diagnostics["value_and_grad_calls"],
    }


if __name__ == "__main__":
    out = main()
    print(f"analytic: mean={out['analytic_mean']:.4f} var={out['analytic_var']:.5f}")
    print(f"SVI:      mean={out['svi_mean']:.4f} var={out['svi_var']:.5f}")
    print(f"NUTS:     mean={out['nuts_mean']:.4f} var={out['nuts_var']:.5f}  "
          f"r_hat={out['r_hat']:.4f}")
