from dvae_tpu_torch.models.lstm_vad import LSTMVad
from dvae_tpu_torch.models.vae import VAE

__all__ = ["LSTMVad", "VAE"]
