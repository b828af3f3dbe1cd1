"""Variational autoencoder with an amortized neural guide.

The port of ``examples/05_vae.py`` to brancher_torch, at its sizes and
seed (no kernel: the networks are ``torch.nn`` modules).

Run from the repository root:  PYTHONPATH=. python3 examples/torch/05_vae.py
"""
from brancher_torch.inference import perform_inference
from brancher_torch.models.vae import VAEConfig, make_vae_data, vae_model


def main(device="cuda", num_points=4096, obs_dim=64, latent_dim=8, hidden_dim=128,
         batch_size=256, iterations=2000, key=0) -> dict:
    data = make_vae_data(num_points=num_points, obs_dim=obs_dim, true_latent=4)
    p_model, q_model = vae_model(data, VAEConfig(latent_dim=latent_dim, hidden_dim=hidden_dim,
                                                 batch_size=batch_size))
    res = perform_inference(p_model, number_iterations=iterations, number_samples=4, lr=1e-3,
                            key=key, device=device)
    curve = [float(v) for v in res.loss_curve]
    # reconstruct: posterior sample through the joint
    post = p_model.get_posterior_sample_dict(1, key=key, device=device)
    tenth = max(len(curve) // 10, 1)
    return {
        "loss_first": curve[0], "loss_last": curve[-1],
        "loss_first_tenth_mean": sum(curve[:tenth]) / tenth,
        "loss_last_tenth_mean": sum(curve[-tenth:]) / tenth,
        "reconstruction_shape": tuple(post["x"].shape),
    }


if __name__ == "__main__":
    out = main()
    print(f"-ELBO: {out['loss_first']:.0f} -> {out['loss_last']:.0f}")
    print("reconstruction logits shape:", out["reconstruction_shape"])
