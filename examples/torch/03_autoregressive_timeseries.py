"""AR(2) time series: the series' log-prob + NUTS over its parameters.

The port of ``examples/03_autoregressive_timeseries.py`` to
brancher_torch, at its sizes and seed.  The recognizer reads the series as
a Normal-learned GLM over its lag matrix, so on the card NUTS runs the
fused value+grad kernel (K3).

Run from the repository root:
PYTHONPATH=. python3 examples/torch/03_autoregressive_timeseries.py
"""
import numpy as np

from brancher_torch.inference import NUTS, sample
from brancher_torch.models.autoregressive import ar_model, make_ar_data

TRUE_COEFFS, TRUE_NOISE = (0.5, 0.2), 0.3


def least_squares(data, order=2):
    """The series' least-squares AR fit: (coefficients, residual scale)."""
    lags = np.stack([data[order - 1 - i:len(data) - 1 - i] for i in range(order)], 1)
    target = data[order:]
    coef = np.linalg.lstsq(lags, target, rcond=None)[0]
    return coef, float(np.std(target - lags @ coef))


def main(device="cuda", length=1000, num_samples=500, num_warmup=500, num_chains=8,
         max_depth=8, key=0) -> dict:
    data = make_ar_data(length=length, coeffs=TRUE_COEFFS, noise=TRUE_NOISE)
    model = ar_model(data, order=2)
    res = sample(model, kernel=NUTS(max_depth=max_depth), num_samples=num_samples,
                 num_warmup=num_warmup, num_chains=num_chains, key=key, device=device)
    lsq_coef, lsq_noise = least_squares(data)
    return {
        "coeffs": res.samples["coeffs"].mean(dim=(0, 1)).cpu().numpy(),
        "coeffs_sd": res.samples["coeffs"].reshape(-1, 2).std(0).cpu().numpy(),
        "coeffs_ess": np.asarray(res.diagnostics["ess"]["coeffs"]),
        "noise_scale": float(res.samples["noise_scale"].mean()),
        "lsq_coeffs": lsq_coef, "lsq_noise": lsq_noise,
        "num_divergences": res.diagnostics["num_divergences"],
        "max_r_hat": float(max(np.max(v) for v in res.diagnostics["r_hat"].values())),
        "fused_family": res.diagnostics["fused_family"],
        "value_and_grad_calls": res.diagnostics["value_and_grad_calls"],
    }


if __name__ == "__main__":
    out = main()
    print(f"coeffs: {out['coeffs'].round(3)} (true {TRUE_COEFFS})")
    print(f"noise scale: {out['noise_scale']:.3f} (true {TRUE_NOISE})")
    print(f"divergences: {out['num_divergences']}")
