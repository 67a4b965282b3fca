"""Flags and helpers shared by the port's trainer CLIs: the training half of
the JAX package's ``scripts/_lib.py`` (``add_common(training=True)`` and
``mangle``), with the same flag names and defaults.

The frame set is ``--frames`` (an ``.h5`` or an ``.npz``), by default the
``.h5`` of the corpus tree (``frame_h5_path``). A machine without ``h5py``
trains on the ``.npz`` that ``create_train_set --format npz`` or
``frames_h5_to_npz`` writes; ``--no-in-memory`` streams an ``.h5`` only.
``--steps-per-dispatch K`` runs K optimizer steps per dispatch: on the card
one CUDA graph over K steps, on the CPU K eager steps. ``--data-parallel``
trains one process per GPU under ``torchrun`` (``_family.trainer_mesh``);
``--multihost`` also requires a group of more than one process. Not
ported: the XLA compile cache (``--no-jit-cache``).
"""

from __future__ import annotations

import argparse
import os

from dvae_tpu_torch.cli._family import (
    add_common,
    add_trainer_parallel,
    frame_h5_path,
    trainer_mesh,
)
from dvae_tpu_torch.data.datasets import FrameDataset
from dvae_tpu_torch.train.loop import LoopConfig


def training_parser(prog: str, doc: str) -> argparse.ArgumentParser:
    """The corpus and device flags of ``_family.add_common`` and the
    training flags of the JAX scripts."""
    ap = add_common(argparse.ArgumentParser(prog=prog, description=doc))
    ap.add_argument("--frames", default=None,
                    help="the frame set, .h5 or .npz (default: the corpus tree's "
                         "ntcd_timit/Clean_<labels>_upsampled.h5); a machine "
                         "without h5py reads the .npz")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--learning-rate", type=float, default=1e-4)
    ap.add_argument("--start-epoch", type=int, default=1)
    ap.add_argument("--end-epoch", type=int, default=500)
    ap.add_argument("--log-interval", type=int, default=250)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--std-norm", action="store_true")
    ap.add_argument("--no-in-memory", action="store_true",
                    help="stream frame batches from the .h5 instead of loading the "
                         "whole split into host memory")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="optimizer steps per dispatch: one CUDA graph over K steps "
                         "on the card; the same batches, noise and math as K = 1")
    ap.add_argument("--device-data", action="store_true",
                    help="upload each split to the device once and gather each "
                         "batch there by index (needs the in-memory dataset)")
    ap.add_argument("--run-name", default=None,
                    help="override the auto-mangled run dir name (use when "
                         "resuming with --start-epoch and a new --end-epoch)")
    ap.add_argument("--z-dim", type=int, default=16)
    ap.add_argument("--h-dim", type=int, nargs="+", default=[128, 128])
    add_trainer_parallel(ap)
    return ap


def parse_training(ap: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse, refuse what the JAX scripts refuse, then build the mesh of
    ``--data-parallel`` / ``--multihost`` as ``args.mesh``."""
    args = ap.parse_args(argv)
    if args.device_data and args.no_in_memory:
        ap.error("--device-data uploads the in-memory split once; drop --no-in-memory")
    args.frames = args.frames or frame_h5_path(args)
    if args.no_in_memory and args.frames.endswith(".npz"):
        ap.error("--no-in-memory streams an .h5; an .npz frame set is read into memory")
    args.mesh = trainer_mesh(args)
    return args


def datasets(args):
    """(train, validation) ``FrameDataset`` of ``--frames``."""
    return (FrameDataset(args.frames, "train", in_memory=not args.no_in_memory),
            FrameDataset(args.frames, "validation", in_memory=not args.no_in_memory))


def loop_config(args) -> LoopConfig:
    return LoopConfig(
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        start_epoch=args.start_epoch, end_epoch=args.end_epoch,
        log_interval=args.log_interval, seed=args.seed, std_norm=args.std_norm,
        steps_per_dispatch=args.steps_per_dispatch, device_data=args.device_data)


def model_dir(args, model_name: str) -> str:
    return os.path.join(args.models_root, model_name)


def hdim_tag(args) -> str:
    return "_".join(f"{h:03d}" for h in args.h_dim)


def mangle(prefix: str, args, extra: str = "") -> str:
    """The reference's run names, e.g.
    ``ntcd_M1_nonorm_hdim_128_128_zdim_016_end_epoch_500``
    (training_M1.py:60); ``--run-name`` overrides it (a resume with another
    ``--end-epoch`` keeps its directory that way)."""
    if getattr(args, "run_name", None):
        return args.run_name
    norm = "norm" if getattr(args, "std_norm", False) else "nonorm"
    return (f"{prefix}_{extra + '_' if extra else ''}{norm}_hdim_{hdim_tag(args)}"
            f"_zdim_{args.z_dim:03d}_end_epoch_{args.end_epoch:03d}")
