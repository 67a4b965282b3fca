from dvae_tpu_torch.models.vae import VAE

__all__ = ["VAE"]
