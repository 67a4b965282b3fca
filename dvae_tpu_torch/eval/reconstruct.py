"""Reconstruction analysis: encode-decode utterances and render figures
(port of ``dvae_tpu.eval.reconstruct``).

Shared engine behind the reconstruct_* CLIs (the reference's
scripts/reconstruct_M1.py etc.): read a wav, take its power spectrogram,
run the VAE forward (optionally label-conditioned, optionally with swapped
labels — the disentanglement probe of reconstruct_M2.py:193-320), and render
the reference's per-utterance figure sets (wave / spectrogram / mask grids
via ``viz.display_multiple_signals``, the same row layouts and file
suffixes).

The model's input power comes from ``ops/stft_power.power_spectrogram``:
on a CUDA tensor the STFT power kernel, one launch per signal; on the CPU
its plain version. The figures' complex spectrogram is ``stft_to_host``'s
matmul DFT. The forward pass draws its latent sample from an explicit
``torch.Generator`` (the JAX package draws from ``PRNGKey(0)``), or takes
an injected standard-normal ``eps``.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from dvae_tpu_torch import viz
from dvae_tpu_torch.ops import stft_power
from dvae_tpu_torch.ops.stft import StftConfig, stft_to_host
from dvae_tpu_torch.ops.targets import clean_speech_vad


def power_spec(wav, cfg: StftConfig = StftConfig(), device=None):
    """``(S, x2)`` of a wav: ``S`` the complex64 STFT on the host (the
    figure rows), ``x2`` the (frames, bins) float32 power on ``device`` (the
    model's input; one STFT power kernel launch on a card)."""
    x = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    with torch.no_grad():
        x2 = stft_power.power_spectrogram(x, cfg)
    return stft_to_host(x, cfg), x2


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def reconstruct(model, x2, y=None, generator: torch.Generator | None = None, eps=None,
                sample: bool = True, return_z: bool = False):
    """Forward pass -> reconstruction variance spectrogram (n_frames, 513),
    on the host.

    Runs on the model's device. The latent sample's noise is ``eps`` when
    given, else drawn from ``generator``, else from a fresh generator seeded
    0 on that device (each call draws the same noise, as each JAX call with
    its default ``PRNGKey(0)`` does). With ``return_z`` also returns the
    forward's second output, the sampled latent of the models that return it
    (needed for the auxiliary-classifier probe,
    reconstruct_M2_info.py:440-442)."""
    dev = _model_device(model)
    xs = torch.as_tensor(x2, dtype=torch.float32, device=dev)
    if eps is not None:
        eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    elif sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(sample=sample, generator=generator, eps=eps)
    with torch.no_grad():
        if y is None:
            out = model(xs, **kw)
        else:
            out = model(xs, torch.as_tensor(y, dtype=torch.float32, device=dev), **kw)
    if return_z:
        return out[0].cpu().numpy(), out[1].cpu().numpy()
    return out[0].cpu().numpy()


def classify(model, method: str, inputs) -> np.ndarray:
    """``model.<method>(inputs)`` (``classify_from_x`` on a spectrogram,
    ``classify_from_z`` on a latent) on the model's device, to the host."""
    with torch.no_grad():
        out = getattr(model, method)(torch.as_tensor(inputs, dtype=torch.float32,
                                                     device=_model_device(model)))
    return out.cpu().numpy()


def sqrt_recon(r: np.ndarray) -> np.ndarray:
    """Decoder output is a variance spectrogram; the reference plots its
    sqrt (amplitude) — reconstruct_M1.py:170."""
    return np.sqrt(np.maximum(np.asarray(r), 0.0))


def label_variants(y: np.ndarray):
    """oracle / all-ones / all-zeros conditioning set (reconstruct_M2.py
    decodes with each to probe disentanglement)."""
    return {"y": y, "ones": np.ones_like(y), "zeros": np.zeros_like(y)}


def oracle_vad(wav, cfg: StftConfig = StftConfig(), device=None) -> np.ndarray:
    """The oracle VAD of a clean wav (``ops/targets.clean_speech_vad``), on
    the host."""
    x = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    return clean_speech_vad(x, cfg).cpu().numpy()


def ntcd_pair_wavs(proc: str, noisy_rel: str, clean_rel: str,
                   labels: str = "vad_labels"):
    """(clean wav path, noisy wav path) for a proc_noisy_clean_pair_dict
    entry, or None when either wav is absent — the pair grid spans SNRs
    ('-5'..'15') that the processed Noisy tree may not contain (the copy
    grid stops at '10', catalog SNRS vs SNRS_NOISY_SPEECH), and a
    missing-file skip keeps the sweep going like the resume-by-skip
    enhancement path does. The label file may be ``.h5`` or ``.npz``."""
    clean_wav_rel = clean_rel.replace("_" + labels, "").replace("_upsampled", "")
    clean_wav_rel = os.path.splitext(clean_wav_rel)[0] + ".wav"
    s_path = os.path.join(proc, clean_wav_rel)
    x_path = os.path.join(proc, noisy_rel)
    if not (os.path.exists(s_path) and os.path.exists(x_path)):
        return None
    return s_path, x_path


def save_signal_rows(out_path, rows, cfg: StftConfig = StftConfig(),
                     vmin: float = -40.0, vmax: float = 20.0):
    """Render one figure from a reference-style ``signal_list``: a list of
    (wav-or-None, spectrogram-or-None, mask-or-None) rows
    (visualization.py:201-269 contract). Default color limits are the
    reconstruct scripts' settings (reconstruct_M1.py:74-75)."""
    fig = viz.display_multiple_signals(
        list(rows), fs=cfg.fs, wlen_sec=cfg.wlen_sec, hop_percent=cfg.hop_percent,
        vmin=vmin, vmax=vmax)
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return out_path


def m1_figure_set(out_base, s_wav, x_wav, S, X, recon_s, recon_x, y,
                  cfg: StftConfig = StftConfig()):
    """The M1 pair of figures (reconstruct_M1.py:188-256 /
    reconstruct_ntcd_M1.py:215-281): ``_s_recon`` = clean signal over two
    identical reconstruction rows with the oracle-VAD mask; ``_x_recon`` =
    mixture, clean+mask, noisy-reconstruction+mask."""
    recon_s, recon_x = sqrt_recon(recon_s), sqrt_recon(recon_x)
    save_signal_rows(str(out_base) + "_s_recon.png", [
        (s_wav, S, None),
        (None, recon_s, y),
        (None, recon_s, y),
    ], cfg)
    save_signal_rows(str(out_base) + "_x_recon.png", [
        (x_wav, X, None),
        (s_wav, S, y),
        (None, recon_x, y),
    ], cfg)


def m2_figure_set(out_base, s_wav, x_wav, S, X, recon_s, recon_x_oracle,
                  recon_x_ones, recon_x_zeros, y,
                  cfg: StftConfig = StftConfig()):
    """The M2 four-figure label-swap probe (reconstruct_M2.py:204-355 /
    reconstruct_ntcd_M2.py:242-393): oracle-conditioned clean and noisy
    reconstructions plus the all-ones / all-zeros noisy decodes, each over
    the mixture + clean-reference rows."""
    recon_s = sqrt_recon(recon_s)
    save_signal_rows(str(out_base) + "_s_recon.png", [
        (s_wav, S, None),
        (None, recon_s, y),
        (None, recon_s, y),
    ], cfg)
    for suffix, recon, mask in (
        ("_x_recon.png", recon_x_oracle, y),
        ("_x_recon_ones.png", recon_x_ones, np.ones_like(y)),
        ("_x_recon_zeros.png", recon_x_zeros, np.zeros_like(y)),
    ):
        save_signal_rows(str(out_base) + suffix, [
            (x_wav, X, None),
            (s_wav, S, y),
            (None, sqrt_recon(recon), mask),
        ], cfg)


def m2_info_figure_set(out_base, s_wav, x_wav, S, X,
                       recon_clean_soft, recon_clean_oracle,
                       recon_x_oracle, recon_x_soft,
                       recon_x_ones, recon_x_zeros,
                       y, y_hat_soft, yz_soft,
                       cfg: StftConfig = StftConfig()):
    """The M2-info six-figure probe (reconstruct_M2_info.py:239-471 /
    reconstruct_ntcd_M2_info.py:258-490):

    - ``_s_recon``: clean decode with the model's OWN soft classification
      next to the oracle-conditioned decode;
    - ``_x_recon`` / ``_x_recon_soft`` / ``_x_recon_ones`` /
      ``_x_recon_zeros``: noisy decodes conditioned on oracle / ŷ_soft /
      ones / zeros;
    - ``_recon_aux``: the auxiliary classifier's z-based prediction
      overlaid on the clean-soft decode and — replicating the reference's
      actual dataflow, where ``reconstruction_oracle`` was last reassigned
      by the ŷ_soft noisy decode (reconstruct_M2_info.py:313-315 vs :456-459)
      — on the noisy-soft decode.
    """
    recon_clean_soft = sqrt_recon(recon_clean_soft)
    recon_x_soft = sqrt_recon(recon_x_soft)
    y_hat_hard = (np.asarray(y_hat_soft) > 0.5).astype(np.float32)
    yz_hard = (np.asarray(yz_soft) > 0.5).astype(np.float32)
    save_signal_rows(str(out_base) + "_s_recon.png", [
        (s_wav, S, None),
        (None, recon_clean_soft, y_hat_soft),
        (None, sqrt_recon(recon_clean_oracle), y),
    ], cfg)
    save_signal_rows(str(out_base) + "_x_recon.png", [
        (x_wav, X, None),
        (s_wav, S, y),
        (None, sqrt_recon(recon_x_oracle), y),
    ], cfg)
    save_signal_rows(str(out_base) + "_x_recon_soft.png", [
        (x_wav, X, None),
        (s_wav, S, y_hat_soft),
        (None, recon_x_soft, y_hat_hard),
    ], cfg)
    for suffix, recon, mask in (
        ("_x_recon_ones.png", recon_x_ones, np.ones_like(y)),
        ("_x_recon_zeros.png", recon_x_zeros, np.zeros_like(y)),
    ):
        save_signal_rows(str(out_base) + suffix, [
            (x_wav, X, None),
            (s_wav, S, y),
            (None, sqrt_recon(recon), mask),
        ], cfg)
    save_signal_rows(str(out_base) + "_recon_aux.png", [
        (s_wav, S, None),
        (None, recon_clean_soft, yz_soft),
        (None, recon_x_soft, yz_hard),
    ], cfg)
