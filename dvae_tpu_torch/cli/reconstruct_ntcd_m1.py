"""M1 encode-decode analysis on NTCD noisy/clean pairs (port of the JAX
package's ``scripts/reconstruct_ntcd_M1.py``).

    python -m dvae_tpu_torch.cli.reconstruct_ntcd_m1 --data-root data \\
        --checkpoint <M1 .pt> --output-dir figures/reconstruct_ntcd_M1

The reference two-figure set per pair (``_s_recon.png``: clean + masked
reconstruction rows; ``_x_recon.png``: mixture / clean+mask /
noisy-reconstruction+mask), frames trimmed to the oracle-label length (the
reference trims to the upsampled-video frame count, which is what the label
file's length encodes). Label files are ``.h5`` (``h5py``) or ``.npz``.
Each pair's two power spectrograms are STFT power kernel launches on the
card; ``--platform cpu`` runs the plain path. Needs ``matplotlib``."""

from __future__ import annotations

import os

from dvae_tpu_torch.cli._family import processed_dir
from dvae_tpu_torch.cli._reconstruct import checked, load_model, ntcd_items, ntcd_name, parser
from dvae_tpu_torch.data.io import read_wav
from dvae_tpu_torch.enhance.evaluate import load_oracle_labels
from dvae_tpu_torch.eval import reconstruct as rec


def main(argv=None) -> int:
    ap = parser("python -m dvae_tpu_torch.cli.reconstruct_ntcd_m1", __doc__,
                "figures/reconstruct_ntcd_M1", ntcd=True)
    args = checked(ap, ap.parse_args(argv))
    model, device = load_model(args, "m1")
    proc = processed_dir(args)
    n_done = 0
    for noisy_rel, clean_rel in ntcd_items(args, args.labels):
        name = ntcd_name(noisy_rel)
        paths = rec.ntcd_pair_wavs(proc, noisy_rel, clean_rel, args.labels)
        if paths is None:
            continue
        s_wav, _ = read_wav(paths[0])
        x_wav, _ = read_wav(paths[1])
        S, s2 = rec.power_spec(s_wav, device=device)
        X, x2 = rec.power_spec(x_wav, device=device)
        y = load_oracle_labels(os.path.join(proc, clean_rel))
        n = min(len(y), s2.shape[0], x2.shape[0])
        recon_s = rec.reconstruct(model, s2[:n])
        recon_x = rec.reconstruct(model, x2[:n])
        rec.m1_figure_set(os.path.join(args.output_dir, name),
                          s_wav, x_wav, S[:n], X[:n], recon_s, recon_x, y[:n])
        print(f"reconstructed {name}")
        n_done += 1
    return n_done


if __name__ == "__main__":
    main()
