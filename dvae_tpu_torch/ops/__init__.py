from dvae_tpu_torch.ops.stft_power import log_power_spectrogram, power_spectrogram

__all__ = ["log_power_spectrogram", "power_spectrogram"]
