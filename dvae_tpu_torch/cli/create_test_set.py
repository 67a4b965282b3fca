"""Synthesize the QUT-noise test mixtures: ``_s/_n/_x.wav`` triplets and the
SNR pickle (port of the JAX package's ``scripts/create_test_set.py``;
``dvae_tpu_torch.data.builders.build_qut_test_set``: a seeded noise type
and SNR per utterance, the power-ratio noise gain, the joint
renormalization). Host-only: no device work.

    python -m dvae_tpu_torch.cli.create_test_set --data-root data \\
        --noise-dir <preprocessed QUT noise>
"""

from __future__ import annotations

import argparse
import os

from dvae_tpu_torch.cli._family import add_common, processed_dir, raw_dir
from dvae_tpu_torch.data.builders import build_qut_test_set


def main(argv=None) -> list:
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.create_test_set", description=__doc__))
    ap.add_argument("--noise-dir", default=None,
                    help="dir with preprocessed QUT noise wavs (default: "
                         "<data-root>/complete/processed/qut_noise)")
    ap.add_argument("--snrs", type=float, nargs="+", default=[-15.0, -10.0, -5.0, 0.0, 5.0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--split", default="test")
    args = ap.parse_args(argv)
    noise_dir = args.noise_dir or os.path.join(args.data_root, "complete", "processed",
                                               "qut_noise")
    out_dir = os.path.join(processed_dir(args), "ntcd_timit", "qutnoise_databases")
    snrs = build_qut_test_set(raw_dir(args), noise_dir, out_dir, dataset_type=args.split,
                              snrs=tuple(args.snrs), seed=args.seed)
    print(f"mixed {len(snrs)} utterances -> {out_dir}")
    return snrs


if __name__ == "__main__":
    main()
