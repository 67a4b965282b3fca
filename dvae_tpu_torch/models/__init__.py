from dvae_tpu_torch.models.blocks import Classifier, Classifier2Classes
from dvae_tpu_torch.models.cvae import CVAE, CVAE_v2, CVAE_v3, CVAE_v4, EncoderClassifier
from dvae_tpu_torch.models.disentangled import DisentangledVAE
from dvae_tpu_torch.models.lstm_vad import LSTMVad
from dvae_tpu_torch.models.vae import VAE

# the reference's class names (its packages/models/models.py)
VariationalAutoencoder = VAE
DeepGenerativeModel = CVAE
DeepGenerativeModel_v2 = CVAE_v2
DeepGenerativeModel_v3 = CVAE_v3
DeepGenerativeModel_v4 = CVAE_v4
DeepGenerativeModel_v5 = DisentangledVAE
Encoder_Classifier = EncoderClassifier
DeepVAD_audio = LSTMVad

__all__ = [
    "CVAE", "CVAE_v2", "CVAE_v3", "CVAE_v4", "Classifier", "Classifier2Classes",
    "DisentangledVAE", "EncoderClassifier", "LSTMVad", "VAE",
    "VariationalAutoencoder", "DeepGenerativeModel", "DeepGenerativeModel_v2",
    "DeepGenerativeModel_v3", "DeepGenerativeModel_v4", "DeepGenerativeModel_v5",
    "Encoder_Classifier", "DeepVAD_audio",
]
