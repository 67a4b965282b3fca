"""Build the consolidated frame-level training set (port of the JAX
package's ``scripts/create_train_set.py``).

    python -m dvae_tpu_torch.cli.create_train_set --data-root data \\
        --labels vad_labels --format npz

Walks ``<data-root>/<dataset-size>/raw/`` through the NTCD catalog and
writes ``<data-root>/<dataset-size>/processed/ntcd_timit/
Clean_<labels>_upsampled.<format>``: ``X_<split>`` / ``Y_<split>`` and the
train statistics (``dvae_tpu_torch.data.builders.build_frame_dataset``).
The spectrograms run on the card, ``--chunk-utterances`` per launch
(``--platform cpu``: the plain PyTorch path). ``--format h5`` (the JAX
builder's file) needs ``h5py``; ``--format npz`` holds the same arrays
and is the route on a machine without it. ``--legacy-video-trim``
reproduces the reference's trim to the video's height (67 frames)."""

from __future__ import annotations

import argparse

from dvae_tpu_torch.cli._family import (
    add_common,
    add_format,
    check_format,
    processed_dir,
    raw_dir,
)
from dvae_tpu_torch.data.builders import build_frame_dataset


def main(argv=None):
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.create_train_set", description=__doc__))
    ap.add_argument("--splits", nargs="+", default=["train", "validation"])
    ap.add_argument("--legacy-video-trim", action="store_true")
    add_format(ap)
    ap.add_argument("--chunk-utterances", type=int, default=256,
                    help="utterances per spectrogram launch")
    args = ap.parse_args(argv)
    check_format(ap, args)
    out = build_frame_dataset(raw_dir(args), processed_dir(args), labels=args.labels,
                              dataset_types=tuple(args.splits),
                              proc_video_dir=processed_dir(args),
                              legacy_video_trim=args.legacy_video_trim, fmt=args.format,
                              chunk=args.chunk_utterances, device=args.platform)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
