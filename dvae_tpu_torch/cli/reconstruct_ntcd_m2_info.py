"""M2-info reconstruction probe on NTCD noisy pairs (port of the JAX
package's ``scripts/reconstruct_ntcd_M2_info.py``).

    python -m dvae_tpu_torch.cli.reconstruct_ntcd_m2_info --data-root data \\
        --checkpoint <M2-info .pt>

The reference six-figure set per pair: the clean decode with the model's OWN
classifier prediction next to the oracle decode (``_s_recon``), noisy
decodes with oracle / ŷ_soft / ones / zeros conditioning (``_x_recon``,
``_x_recon_soft``, ``_x_recon_ones``, ``_x_recon_zeros``), and the auxiliary
classifier's z-based prediction (``_recon_aux``). Frames trimmed to the
oracle-label length (= the reference's upsampled-video trim); label files
are ``.h5`` or ``.npz``. Each pair's two power spectrograms are STFT power
kernel launches on the card; ``--platform cpu`` runs the plain path. Needs
``matplotlib``."""

from __future__ import annotations

import os

import numpy as np

from dvae_tpu_torch.cli._family import processed_dir
from dvae_tpu_torch.cli._reconstruct import checked, load_model, ntcd_items, ntcd_name, parser
from dvae_tpu_torch.data.io import read_wav
from dvae_tpu_torch.enhance.evaluate import load_oracle_labels
from dvae_tpu_torch.eval import reconstruct as rec


def main(argv=None) -> int:
    ap = parser("python -m dvae_tpu_torch.cli.reconstruct_ntcd_m2_info", __doc__,
                "figures/reconstruct_ntcd_M2_info", ntcd=True)
    args = ap.parse_args(argv)
    if args.labels != "vad_labels":
        # consistent with evaluate_ntcd_m2_info_vad: the M2-info model is
        # VAD-conditioned; silently ignoring the flag would lie to the user
        ap.error("the M2-info model is VAD-conditioned; use --labels vad_labels")
    checked(ap, args)
    model, device = load_model(args, "v5")
    proc = processed_dir(args)
    n_done = 0
    for noisy_rel, clean_rel in ntcd_items(args, "vad_labels"):
        name = ntcd_name(noisy_rel)
        paths = rec.ntcd_pair_wavs(proc, noisy_rel, clean_rel, "vad_labels")
        if paths is None:
            continue
        s_wav, _ = read_wav(paths[0])
        x_wav, _ = read_wav(paths[1])
        S, s2 = rec.power_spec(s_wav, device=device)
        X, x2 = rec.power_spec(x_wav, device=device)
        y = load_oracle_labels(os.path.join(proc, clean_rel))
        n = min(len(y), s2.shape[0], x2.shape[0])
        y = y[:n]
        # the model's own x->y classification of the CLEAN spectrogram
        # (reconstruct_ntcd_M2_info.py:195-197)
        y_hat_soft = rec.classify(model, "classify_from_x", s2[:n])
        recon_clean_soft, z = rec.reconstruct(model, s2[:n], y_hat_soft, return_z=True)
        recon_clean_oracle = rec.reconstruct(model, s2[:n], y)
        recon_x_oracle = rec.reconstruct(model, x2[:n], y)
        recon_x_soft = rec.reconstruct(model, x2[:n], y_hat_soft)
        recon_x_ones = rec.reconstruct(model, x2[:n], np.ones_like(y))
        recon_x_zeros = rec.reconstruct(model, x2[:n], np.zeros_like(y))
        # auxiliary classifier on the clean-soft encode's latent
        # (reconstruct_ntcd_M2_info.py:459-461)
        yz_soft = rec.classify(model, "classify_from_z", z)
        rec.m2_info_figure_set(os.path.join(args.output_dir, name),
                               s_wav, x_wav, S[:n], X[:n],
                               recon_clean_soft, recon_clean_oracle,
                               recon_x_oracle, recon_x_soft,
                               recon_x_ones, recon_x_zeros,
                               y, y_hat_soft, yz_soft)
        print(f"reconstructed {name}")
        n_done += 1
    return n_done


if __name__ == "__main__":
    main()
