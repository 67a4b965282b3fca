"""M1 encode-decode analysis on QUT-mixture triplets (``_s/_n/_x.wav``; port
of the JAX package's ``scripts/reconstruct_M1.py``).

    python -m dvae_tpu_torch.cli.create_test_set --data-root data --noise-dir <noise>
    python -m dvae_tpu_torch.cli.reconstruct_m1 --data-root data --checkpoint <M1 .pt>

Reconstructs the clean and noisy spectrograms through the trained M1 VAE and
saves the reference's two-figure set per utterance (``_s_recon.png`` = clean
+ two oracle-VAD-masked reconstruction rows, ``_x_recon.png`` = mixture /
clean+mask / noisy-reconstruction+mask — reconstruct_M1.py:188-256). Each
utterance's two power spectrograms are STFT power kernel launches on the
card; ``--platform cpu`` runs the plain path. Needs ``matplotlib``."""

from __future__ import annotations

import os

from dvae_tpu_torch.cli._reconstruct import checked, load_model, parser, qut_mixtures
from dvae_tpu_torch.data.io import read_wav
from dvae_tpu_torch.eval import reconstruct as rec


def main(argv=None) -> int:
    ap = parser("python -m dvae_tpu_torch.cli.reconstruct_m1", __doc__,
                "figures/reconstruct_M1", ntcd=False)
    args = checked(ap, ap.parse_args(argv))
    model, device = load_model(args, "m1")
    mixtures = qut_mixtures(args)
    for x_path in mixtures:
        base = x_path[: -len("_x.wav")]
        name = os.path.basename(base)
        s_wav, _ = read_wav(base + "_s.wav")
        x_wav, _ = read_wav(x_path)
        S, s2 = rec.power_spec(s_wav, device=device)
        X, x2 = rec.power_spec(x_wav, device=device)
        recon_s = rec.reconstruct(model, s2)
        recon_x = rec.reconstruct(model, x2)
        # the reference reads the oracle VAD from the builder h5
        # (reconstruct_M1.py:172-177); recomputing it from the clean wav is
        # value-identical (the h5 was built with the same function and the
        # threshold is scale-invariant)
        y = rec.oracle_vad(s_wav, device=device)
        rec.m1_figure_set(os.path.join(args.output_dir, name),
                          s_wav, x_wav, S, X, recon_s, recon_x, y)
        print(f"reconstructed {name}")
    return len(mixtures)


if __name__ == "__main__":
    main()
