"""M2-info reconstruction probe on QUT mixtures (port of the JAX package's
``scripts/reconstruct_M2_info.py``).

    python -m dvae_tpu_torch.cli.reconstruct_m2_info --data-root data \\
        --checkpoint <M2-info .pt>

The reference six-figure set per utterance: the clean decode with the
model's OWN classifier prediction next to the oracle decode (``_s_recon``),
noisy decodes with oracle / ŷ_soft / ones / zeros conditioning
(``_x_recon``, ``_x_recon_soft``, ``_x_recon_ones``, ``_x_recon_zeros``),
and the auxiliary classifier's z-based prediction (``_recon_aux``). Each
utterance's two power spectrograms are STFT power kernel launches on the
card; ``--platform cpu`` runs the plain path. Needs ``matplotlib``."""

from __future__ import annotations

import os

import numpy as np

from dvae_tpu_torch.cli._reconstruct import checked, load_model, parser, qut_mixtures
from dvae_tpu_torch.data.io import read_wav
from dvae_tpu_torch.eval import reconstruct as rec


def main(argv=None) -> int:
    ap = parser("python -m dvae_tpu_torch.cli.reconstruct_m2_info", __doc__,
                "figures/reconstruct_M2_info", ntcd=False)
    args = checked(ap, ap.parse_args(argv))
    model, device = load_model(args, "v5")
    mixtures = qut_mixtures(args)
    for x_path in mixtures:
        base = x_path[: -len("_x.wav")]
        name = os.path.basename(base)
        s_wav, _ = read_wav(base + "_s.wav")
        x_wav, _ = read_wav(x_path)
        S, s2 = rec.power_spec(s_wav, device=device)
        X, x2 = rec.power_spec(x_wav, device=device)
        y = rec.oracle_vad(s_wav, device=device)[:, None]
        # the model's own x->y classification of the CLEAN spectrogram
        # (reconstruct_M2_info.py:195-200)
        y_hat_soft = rec.classify(model, "classify_from_x", s2)
        recon_clean_soft, z = rec.reconstruct(model, s2, y_hat_soft, return_z=True)
        recon_clean_oracle = rec.reconstruct(model, s2, y)
        recon_x_oracle = rec.reconstruct(model, x2, y)
        recon_x_soft = rec.reconstruct(model, x2, y_hat_soft)
        recon_x_ones = rec.reconstruct(model, x2, np.ones_like(y))
        recon_x_zeros = rec.reconstruct(model, x2, np.zeros_like(y))
        # auxiliary classifier on the clean-soft encode's latent
        # (reconstruct_M2_info.py:440-442)
        yz_soft = rec.classify(model, "classify_from_z", z)
        rec.m2_info_figure_set(os.path.join(args.output_dir, name),
                               s_wav, x_wav, S, X,
                               recon_clean_soft, recon_clean_oracle,
                               recon_x_oracle, recon_x_soft,
                               recon_x_ones, recon_x_zeros,
                               y, y_hat_soft, yz_soft)
        print(f"reconstructed {name}")
    return len(mixtures)


if __name__ == "__main__":
    main()
