"""Scoring and reconstruction analysis (port of ``dvae_tpu.eval``): SI-SDR,
(E)STOI, PESQ and the per-condition statistics tables are host numpy, copies
of the JAX package's modules; ``reconstruct`` runs the models on a device
and draws the reference's figures (``matplotlib``, imported where a figure
is drawn)."""

from dvae_tpu_torch.eval.si_sdr import energy_ratios, si_sdr_components, si_sdr_leroux
from dvae_tpu_torch.eval.stats import compute_stats, mean_confidence_interval
from dvae_tpu_torch.eval.stoi import stoi

__all__ = [
    "si_sdr_components",
    "energy_ratios",
    "si_sdr_leroux",
    "mean_confidence_interval",
    "compute_stats",
    "stoi",
]
