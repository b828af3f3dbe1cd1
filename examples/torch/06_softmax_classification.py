"""Softmax digit classification with minibatch ML training (the
reference's MNIST-classifier example family): a learnable-weight
CategoricalVariable trained by MaximumLikelihood through the
RandomIndices/EmpiricalVariable data-loader pattern.

The port of ``examples/06_softmax_classification.py`` to brancher_torch,
at its sizes and seed.  It reads scikit-learn's bundled digits (no
download), so it runs only where scikit-learn is installed.

Run from the repository root:
PYTHONPATH=. python3 examples/torch/06_softmax_classification.py
"""
import numpy as np

import brancher_torch.functions as BF
from brancher_torch import (
    CategoricalVariable,
    DeterministicVariable,
    EmpiricalVariable,
    ProbabilisticModel,
    RandomIndices,
)
from brancher_torch.inference import MaximumLikelihood, perform_inference


def load_data():
    from sklearn.datasets import load_digits

    digits = load_digits()
    return (digits.data / 16.0).astype(np.float32), digits.target.astype(np.int32)


def main(device="cuda", iterations=800, batch_size=256, key=0) -> dict:
    x_all, y_all = load_data()
    n, d, k = x_all.shape[0], x_all.shape[1], 10

    idx = RandomIndices(n, batch_size, "idx")
    xb = EmpiricalVariable(x_all, name="xb", indices=idx)
    yb = EmpiricalVariable(y_all, name="yb", indices=idx)

    w = DeterministicVariable(np.zeros((d, k), np.float32), "w", learnable=True)
    b = DeterministicVariable(np.zeros(k, np.float32), "b", learnable=True)
    y = CategoricalVariable(logits=BF.matmul(xb, w) + b, name="y",
                            log_prob_scale=float(n) / batch_size)
    y.observe(yb)
    model = ProbabilisticModel([y])

    res = perform_inference(model, number_iterations=iterations, number_samples=1, lr=0.05,
                            inference_method=MaximumLikelihood(), key=key, device=device)
    # accuracy with the trained weights
    w_hat = res.params["p"]["w"].detach().cpu().numpy()
    b_hat = res.params["p"]["b"].detach().cpu().numpy()
    pred = (x_all @ w_hat + b_hat).argmax(-1)
    return {"nll_first": float(res.loss_curve[0]), "nll_last": float(res.loss_curve[-1]),
            "train_accuracy": float((pred == y_all).mean())}


if __name__ == "__main__":
    out = main()
    print(f"NLL: {out['nll_first']:.0f} -> {out['nll_last']:.0f}")
    print("train accuracy:", round(out["train_accuracy"], 4))
