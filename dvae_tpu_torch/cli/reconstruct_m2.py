"""M2 label-swap disentanglement probe on QUT mixtures (port of the JAX
package's ``scripts/reconstruct_M2.py``).

    python -m dvae_tpu_torch.cli.reconstruct_m2 --data-root data --checkpoint <M2 .pt>

The reference four-figure set per utterance: oracle-conditioned clean decode
(``_s_recon``), then the NOISY spectrogram decoded with oracle / all-ones /
all-zeros labels (``_x_recon``, ``_x_recon_ones``, ``_x_recon_zeros``), each
over the mixture and clean-reference rows — a visual check of how much the
reconstruction depends on the label. The oracle labels are the clean wav's
VAD, or its IBM with ``--labels ibm_labels``. Each utterance's two power
spectrograms are STFT power kernel launches on the card; ``--platform cpu``
runs the plain path. Needs ``matplotlib``."""

from __future__ import annotations

import os

import numpy as np
import torch

from dvae_tpu_torch.cli._family import y_dim_for
from dvae_tpu_torch.cli._reconstruct import checked, load_model, parser, qut_mixtures
from dvae_tpu_torch.data.io import read_wav
from dvae_tpu_torch.eval import reconstruct as rec
from dvae_tpu_torch.ops.targets import clean_speech_ibm


def main(argv=None) -> int:
    ap = parser("python -m dvae_tpu_torch.cli.reconstruct_m2", __doc__,
                "figures/reconstruct_M2", ntcd=False)
    ap.add_argument("--model-variant", default="v1", choices=["v1", "v2"],
                    help="v1 = CVAE (encoder sees [x; y]); v2 = CVAE_v2 (encoder on x "
                         "only) for training_m2 --model-variant v2 checkpoints")
    args = checked(ap, ap.parse_args(argv))
    y_dim = y_dim_for(args.labels)
    model, device = load_model(args, "m2" if args.model_variant == "v1" else "m2v2", y_dim)
    mixtures = qut_mixtures(args)
    for x_path in mixtures:
        base = x_path[: -len("_x.wav")]
        name = os.path.basename(base)
        s_wav, _ = read_wav(base + "_s.wav")
        x_wav, _ = read_wav(x_path)
        S, s2 = rec.power_spec(s_wav, device=device)
        X, x2 = rec.power_spec(x_wav, device=device)
        if y_dim == 1:
            y = rec.oracle_vad(s_wav, device=device)[:, None]
        else:
            # the IBM of the clean spectrogram's magnitude
            y = clean_speech_ibm(torch.as_tensor(np.abs(S), device=device)).cpu().numpy()
        recon_s = rec.reconstruct(model, s2, y)
        recon_x = {tag: rec.reconstruct(model, x2, yv)
                   for tag, yv in rec.label_variants(y).items()}
        rec.m2_figure_set(os.path.join(args.output_dir, name),
                          s_wav, x_wav, S, X, recon_s,
                          recon_x["y"], recon_x["ones"], recon_x["zeros"], y)
        print(f"reconstructed {name}")
    return len(mixtures)


if __name__ == "__main__":
    main()
