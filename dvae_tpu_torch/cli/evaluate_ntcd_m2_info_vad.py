"""Enhance the noisy NTCD-TIMIT test set with M2-info, the disentangled VAE
conditioned on voice activity (port of the JAX package's
``scripts/evaluate_ntcd_M2_info_vad.py``).

    python -m dvae_tpu_torch.cli.evaluate_ntcd_m2_info_vad --data-root data \\
        --model-dir models/ntcd_M2_info_... --y-source self-soft --snr all

``--model-class v5`` is ``DisentangledVAE``, ``v4`` ``CVAE_v4``, ``v3``
``CVAE_v3``: all enhance with the encoder on x and the decoder on [z; y].
Labels: the oracle label files, a classifier's precomputed
``*_y_hat_hard.pt/.npy``, the constant ablations, or ``self-soft``, the
model's own x -> y classifier on each clean utterance's power spectrogram
(one STFT power kernel launch per utterance). ``--save-labels`` also writes
the labels as ``<utt><suffix>.npy`` beside the enhanced wavs. Outputs and
device as in ``evaluate_ntcd_m1``; the oracle and constant sources read
the label files, ``.h5`` with ``h5py`` or ``.npz`` without it."""

from __future__ import annotations

import os

import numpy as np

from dvae_tpu_torch.cli._family import processed_dir, shard_of, warn_peem_family
from dvae_tpu_torch.cli._sweep import (
    add_label_source,
    build_enhancer,
    label_loader,
    parse_sweep_args,
    run_sweep,
    sweep_parser,
)
from dvae_tpu_torch.data.catalog import ntcd_timit
from dvae_tpu_torch.data.io import read_wav
from dvae_tpu_torch.enhance.evaluate import clean_audio_rel, shard_slice
from dvae_tpu_torch.enhance.labeling import classify_method_of, self_soft_labels
from dvae_tpu_torch.ops.stft import StftConfig

SUFFIX = {"oracle": "_oracle_y", "classifier": "_y_hat_hard", "ones": "_oracle_1",
          "zeros": "_oracle_0", "self-soft": "_y_hat_soft"}


def parse_args(argv=None):
    ap = sweep_parser("python -m dvae_tpu_torch.cli.evaluate_ntcd_m2_info_vad", __doc__)
    add_label_source(ap, list(SUFFIX), "; self-soft = the model's own classifier on the "
                     "clean spectrogram (soft probabilities, suffix _y_hat_soft)")
    ap.add_argument("--save-labels", action="store_true",
                    help="also write the labels the enhancement is conditioned on as "
                         "<utt><suffix>.npy next to the enhanced wavs")
    ap.add_argument("--model-class", default="v5", choices=["v5", "v4", "v3"],
                    help="v5 = DisentangledVAE (default); v4 = CVAE_v4; v3 = CVAE_v3")
    args = parse_sweep_args(ap, argv)
    if args.y_source == "classifier" and not args.classifier_dir:
        ap.error("--y-source classifier requires --classifier-dir")
    if args.labels != "vad_labels":
        ap.error("the M2-info model is VAD-conditioned; use --labels vad_labels")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    model_class = args.model_class
    warn_peem_family(args, model_class)
    enh, out_dir, norm = build_enhancer(args, model_class, 1, "dec_only")
    proc = processed_dir(args)
    stft_cfg = StftConfig()

    def self_soft(clean_rel):
        s, _ = read_wav(os.path.join(proc, clean_audio_rel(clean_rel, args.labels)))
        return self_soft_labels(enh.model, [s.astype(np.float32)], stft_cfg, 1,
                                classify_method_of(model_class), norm=norm,
                                norm_eps=enh.cfg.norm_eps)[0]

    y_loader = label_loader(args, 1, self_soft)
    suffix = SUFFIX[args.y_source]
    if args.save_labels:
        # a pre-pass over the catalog, not a hook in the sweep: resume-by-skip
        # drops already-enhanced utterances, whose labels are written too
        pairs = ntcd_timit.proc_noisy_clean_pair_dict(proc + "/", "test", args.dataset_size,
                                                      args.labels, True)
        items = [it for it in pairs.items()
                 if args.snr == "all" or it[0].split("/")[-4] == str(args.snr)]
        n_saved = 0
        for noisy_rel, clean_rel in shard_slice(items, shard_of(args)):
            dest = os.path.join(out_dir, os.path.splitext(noisy_rel)[0] + suffix + ".npy")
            if os.path.exists(dest):
                continue
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            np.save(dest, y_loader(noisy_rel, clean_rel))
            n_saved += 1
        print(f"saved {n_saved} label files ({suffix}.npy) under {out_dir}")
    return run_sweep(args, enh, out_dir, y_loader, suffix)


if __name__ == "__main__":
    main()
