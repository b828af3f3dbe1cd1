"""Bayesian logistic regression: minibatched SVI and vectorized NUTS.

The port of ``examples/02_bayesian_logistic_regression.py`` to
brancher_torch, at its sizes and seed.  On the card NUTS runs the fused
Bernoulli-logit value+grad kernel (K1) over the 64 chains.

Run from the repository root:
PYTHONPATH=. python3 examples/torch/02_bayesian_logistic_regression.py
"""
import numpy as np

from brancher_torch.inference import NUTS, perform_inference, sample
from brancher_torch.models.logistic_regression import (
    logistic_regression_model,
    make_logreg_data,
)


def main(device="cuda", num_points=1000, dim=16, num_samples=500, num_warmup=500,
         num_chains=64, max_depth=8, svi_iterations=2000, batch_size=128, key=0) -> dict:
    x, y, w_true = make_logreg_data(num_points=num_points, dim=dim)

    # full-batch NUTS posterior (the chains batched on the card)
    model = logistic_regression_model(x, y)
    res = sample(model, kernel=NUTS(max_depth=max_depth), num_samples=num_samples,
                 num_warmup=num_warmup, num_chains=num_chains, key=key, device=device)
    w_post = res.samples["w"].mean(dim=(0, 1)).cpu().numpy()

    # minibatch SVI with the reference's RandomIndices/EmpiricalVariable pattern
    mini = logistic_regression_model(x, y, batch_size=batch_size)
    svi = perform_inference(mini, number_iterations=svi_iterations, number_samples=8,
                            lr=0.02, key=key, device=device)
    loc, _ = svi.guide.posterior_moments(svi.params["q"])
    loc = loc.detach().cpu().numpy()
    return {
        "corr_nuts_truth": float(np.corrcoef(w_post, w_true)[0, 1]),
        "corr_svi_nuts": float(np.corrcoef(loc, w_post)[0, 1]),
        "w_post": w_post, "w_svi": loc, "w_true": w_true,
        "w_sd": res.samples["w"].reshape(-1, dim).std(0).cpu().numpy(),
        "w_ess": np.asarray(res.diagnostics["ess"]["w"]),
        "max_r_hat": float(np.max(res.diagnostics["r_hat"]["w"])),
        "num_divergences": res.diagnostics["num_divergences"],
        "fused_family": res.diagnostics["fused_family"],
        "value_and_grad_calls": res.diagnostics["value_and_grad_calls"],
    }


if __name__ == "__main__":
    out = main()
    print("corr(posterior mean, true weights):", round(out["corr_nuts_truth"], 4))
    print("corr(SVI mean, NUTS mean):", round(out["corr_svi_nuts"], 4))
