"""Copy the pre-mixed Noisy_TCDTIMIT wavs of a split into the processed
layout (port of the JAX package's ``scripts/create_audio_set_ntcd_noise.py``;
``dvae_tpu_torch.data.builders.copy_ntcd_noisy_test``). Host-only: no
device work.

    python -m dvae_tpu_torch.cli.create_audio_set_ntcd_noise --data-root data
"""

from __future__ import annotations

import argparse

from dvae_tpu_torch.cli._family import add_common, processed_dir, raw_dir
from dvae_tpu_torch.data.builders import copy_ntcd_noisy_test


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.create_audio_set_ntcd_noise", description=__doc__))
    ap.add_argument("--split", default="test")
    args = ap.parse_args(argv)
    n = copy_ntcd_noisy_test(raw_dir(args), processed_dir(args), dataset_type=args.split,
                             dataset_size=args.dataset_size)
    print(f"copied {n} noisy wavs")
    return n


if __name__ == "__main__":
    main()
