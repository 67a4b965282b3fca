"""Scale-invariant SDR/SIR/SAR (Le Roux et al.), numpy on the host (the
port's copy of ``dvae_tpu.eval.si_sdr``, the reference's
packages/metrics.py:12-82). Kept operation for operation, so that it gives
the JAX package's floats bit for bit.
"""

from __future__ import annotations

import numpy as np


def si_sdr_components(s_hat, s, n):
    """Decompose s_hat = alpha_s*s + alpha_n*n + e_art (metrics.py:12-37)."""
    alpha_s = np.dot(s_hat, s) / np.linalg.norm(s) ** 2
    s_target = alpha_s * s
    alpha_n = np.dot(s_hat, n) / np.linalg.norm(n) ** 2
    e_noise = alpha_n * n
    e_art = s_hat - s_target - e_noise
    return s_target, e_noise, e_art


def energy_ratios(s_hat, s, n):
    """(si_sdr, si_sir, si_sar) in dB (metrics.py:39-60)."""
    s_target, e_noise, e_art = si_sdr_components(s_hat, s, n)
    si_sdr = 10 * np.log10(np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_noise + e_art) ** 2)
    si_sir = 10 * np.log10(np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_noise) ** 2)
    si_sar = 10 * np.log10(np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_art) ** 2)
    return si_sdr, si_sir, si_sar


def si_sdr_leroux(s_hat, s):
    """Scale-invariant SDR against the clean reference (metrics.py:62-82)."""
    alpha_s = np.dot(s_hat, s) / np.linalg.norm(s) ** 2
    s_target = alpha_s * s
    return 10 * np.log10(np.linalg.norm(s_target) ** 2 / np.linalg.norm(s_target - s_hat) ** 2)
