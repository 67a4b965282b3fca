"""Build the upsampled lip videos, their label files and the pixel
statistics (port of the JAX package's ``scripts/create_video_train_files.py``).

    python -m dvae_tpu_torch.cli.create_video_train_files --data-root data \\
        --format npz

Walks ``<data-root>/<dataset-size>/raw/`` through the NTCD catalog and
writes under ``<data-root>/<dataset-size>/processed/``
(``dvae_tpu_torch.data.builders.build_video_files``): for each lip
``.mat`` of ``--splits``, ``ntcd_timit/matlab_raw/<split>/<spk>/
<utt>_upsampled.<format>`` (``X`` (67, 67, frames), the IDCT-preprocessed
frames upsampled from 30 to 62.5 fps), the clean utterance's
``ntcd_timit/Clean/<split>/<spk>/<utt>_<labels>_upsampled.<format>``, and
from the train split ``ntcd_timit/matlab_raw/
ntcd_timit_upsampled_statistics.<format>``. The IDCT and the labels run on
the card (``--platform cpu``: the plain PyTorch path; the JAX builder runs
on the CPU by default). NTCD's ``.mat`` files are matlab v7.3, that is
HDF5, so the walk needs ``h5py``: run it on a host that has it, with
``--format npz`` for a machine that has not. ``--format h5`` (the JAX
builder's files) needs ``h5py`` to write too."""

from __future__ import annotations

import argparse

from dvae_tpu_torch.cli._family import (
    add_common,
    add_format,
    check_format,
    processed_dir,
    raw_dir,
)
from dvae_tpu_torch.data.builders import build_video_files


def main(argv=None):
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.create_video_train_files", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--splits", nargs="+", default=["train", "validation", "test"])
    ap.add_argument("--workers", type=int, default=None)
    add_format(ap)
    args = ap.parse_args(argv)
    check_format(ap, args)
    stats = build_video_files(raw_dir(args), processed_dir(args),
                              dataset_types=tuple(args.splits), labels=args.labels,
                              workers=args.workers, fmt=args.format, device=args.platform)
    print("done")
    return stats


if __name__ == "__main__":
    main()
