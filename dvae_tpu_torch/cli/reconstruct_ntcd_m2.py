"""M2 label-swap disentanglement probe on NTCD noisy pairs (port of the JAX
package's ``scripts/reconstruct_ntcd_M2.py``).

    python -m dvae_tpu_torch.cli.reconstruct_ntcd_m2 --data-root data \\
        --checkpoint <M2 .pt> [--y-source classifier --classifier-dir <dir>]

The reference four-figure set per pair: ``_s_recon`` (oracle-conditioned
clean decode) plus ``_x_recon`` / ``_x_recon_ones`` / ``_x_recon_zeros``
noisy decodes over mixture + clean-reference rows. Labels are the oracle
label files (``.h5`` or ``.npz``) or a classifier's ``*_y_hat_hard.pt/.npy``
(the condition-mirrored file first, as the sweeps take them). Each pair's
two power spectrograms are STFT power kernel launches on the card;
``--platform cpu`` runs the plain path. Needs ``matplotlib``."""

from __future__ import annotations

import os

from dvae_tpu_torch.cli._family import processed_dir, y_dim_for
from dvae_tpu_torch.cli._reconstruct import checked, load_model, ntcd_items, ntcd_name, parser
from dvae_tpu_torch.data.io import read_wav
from dvae_tpu_torch.enhance.evaluate import find_classifier_labels, load_oracle_labels
from dvae_tpu_torch.eval import reconstruct as rec


def main(argv=None) -> int:
    ap = parser("python -m dvae_tpu_torch.cli.reconstruct_ntcd_m2", __doc__,
                "figures/reconstruct_ntcd_M2", ntcd=True)
    ap.add_argument("--y-source", default="oracle", choices=["oracle", "classifier"])
    ap.add_argument("--classifier-dir", default=None)
    ap.add_argument("--model-variant", default="v1", choices=["v1", "v2"],
                    help="v1 = CVAE (encoder sees [x; y]); v2 = CVAE_v2 (encoder on x "
                         "only) for training_m2 --model-variant v2 checkpoints")
    args = ap.parse_args(argv)
    if args.y_source == "classifier" and not args.classifier_dir:
        ap.error("--y-source classifier requires --classifier-dir")
    checked(ap, args)
    y_dim = y_dim_for(args.labels)
    model, device = load_model(args, "m2" if args.model_variant == "v1" else "m2v2", y_dim)
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
        if args.y_source == "oracle":
            y = load_oracle_labels(os.path.join(proc, clean_rel))
        else:
            base = os.path.splitext(os.path.basename(noisy_rel))[0]
            spk = noisy_rel.split("/")[-2]
            # rel_dir: prefer labels predicted from THIS noise/SNR condition
            # (predict_vad_labels --source noisy mirrors the noisy tree)
            y = find_classifier_labels(args.classifier_dir, spk, base, y_dim,
                                       rel_dir=os.path.dirname(noisy_rel))
        n = min(len(y), s2.shape[0], x2.shape[0])
        y = y[:n]
        recon_s = rec.reconstruct(model, s2[:n], y)
        recon_x = {tag: rec.reconstruct(model, x2[:n], yv)
                   for tag, yv in rec.label_variants(y).items()}
        rec.m2_figure_set(os.path.join(args.output_dir, name),
                          s_wav, x_wav, S[:n], X[:n], recon_s,
                          recon_x["y"], recon_x["ones"], recon_x["zeros"], y)
        print(f"reconstructed {name}")
        n_done += 1
    return n_done


if __name__ == "__main__":
    main()
