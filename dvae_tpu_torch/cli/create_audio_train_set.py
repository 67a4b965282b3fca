"""Copy the clean and noisy wavs into the processed layout, and write the
per-utterance label files and the noisy log-power statistics (port of the
JAX package's ``scripts/create_audio_train_set.py``).

    python -m dvae_tpu_torch.cli.create_audio_train_set --data-root data \\
        --format npz

Walks ``<data-root>/<dataset-size>/raw/`` through the NTCD catalog and
writes under ``<data-root>/<dataset-size>/processed/``
(``dvae_tpu_torch.data.builders.build_audio_train_set``): each clean wav
with its ``<utt>_<labels>_upsampled.<format>`` label file, the noisy wavs,
and ``ntcd_timit/Noisy/ntcd_timit_log_power_spec_upsampled_statistics.
<format>`` from the train mixtures, each trimmed to its clean utterance's
lip video (which must exist). The spectrograms run on the card,
``--chunk-utterances`` per launch (``--platform cpu``: the plain PyTorch
path; the JAX builder runs on the CPU by default). ``--format h5`` (the
JAX builder's files) needs ``h5py``; ``--format npz`` holds the same
arrays and is the route on a machine without it."""

from __future__ import annotations

import argparse

from dvae_tpu_torch.cli._family import (
    add_common,
    add_format,
    check_format,
    processed_dir,
    raw_dir,
)
from dvae_tpu_torch.data.builders import build_audio_train_set


def main(argv=None):
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.create_audio_train_set", description=__doc__))
    ap.add_argument("--splits", nargs="+", default=["train", "validation", "test"])
    ap.add_argument("--workers", type=int, default=None)
    add_format(ap)
    ap.add_argument("--chunk-utterances", type=int, default=256,
                    help="utterances per spectrogram launch")
    args = ap.parse_args(argv)
    check_format(ap, args)
    stats = build_audio_train_set(raw_dir(args), processed_dir(args),
                                  dataset_types=tuple(args.splits), labels=args.labels,
                                  dataset_size=args.dataset_size, workers=args.workers,
                                  fmt=args.format, chunk=args.chunk_utterances,
                                  device=args.platform)
    print("done")
    return stats


if __name__ == "__main__":
    main()
