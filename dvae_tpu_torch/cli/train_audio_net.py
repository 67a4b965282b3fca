"""Train the audio LSTM voice-activity classifier on noisy whole utterances
(port of the JAX package's ``scripts/train_audio_net.py``).

    python -m dvae_tpu_torch.cli.train_audio_net --data-root data \\
        --std-norm --stats-h5 <processed>/ntcd_timit/Noisy/\\
ntcd_timit_log_power_spec_upsampled_statistics.npz

``LSTMVad(513, --hidden, --num-layers)`` over the noisy log-power
spectrogram (``StftConfig(center=True)``, one STFT power launch per batch
on the card), the length-masked BCE, F1 per epoch and one checkpoint per
epoch (prefix ``VAD``) under ``<models-root>/ntcd_audio_vad_lstm_<hidden>x
<layers>[_norm]`` (``train/sequence.py::fit_sequence``). The utterances
are the catalog's (processed noisy wav, clean label file) pairs of
``--train-split`` / ``--valid-split`` that exist on disk; the label files
are ``.h5`` or ``.npz`` (``create_audio_train_set --format``).
``--stats-h5`` is the statistics file for ``--std-norm``, ``.h5`` or
``.npz``; its default is the ``.h5`` the JAX builder writes, so a machine
without ``h5py`` passes the ``.npz``. The weights are initialized from
``--seed`` by torch's own rule. ``--platform cpu`` runs the plain path.
``--data-parallel`` trains one process per GPU under ``torchrun``, each
batching its rows of every batch (``--multihost`` also requires a group
of more than one process)."""

from __future__ import annotations

import argparse
import os

import torch

from dvae_tpu_torch.cli._family import (
    add_common,
    add_trainer_parallel,
    processed_dir,
    read_norm_stats,
    trainer_mesh,
)
from dvae_tpu_torch.data.builders import NOISY_STATS
from dvae_tpu_torch.data.catalog import ntcd_timit
from dvae_tpu_torch.data.datasets import UtteranceDataset
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.models import LSTMVad
from dvae_tpu_torch.ops.stft import StftConfig
from dvae_tpu_torch.train.sequence import (
    batch_utterances,
    fit_sequence,
    make_lstm_vad_eval,
    make_lstm_vad_step,
)
from dvae_tpu_torch.train.steps import adam


def parse_args(argv=None) -> argparse.Namespace:
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.train_audio_net", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--learning-rate", type=float, default=1e-4)
    ap.add_argument("--start-epoch", type=int, default=1)
    ap.add_argument("--end-epoch", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run-name", default=None, help="override the auto model dir name")
    add_trainer_parallel(ap)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--seq-batch-size", type=int, default=16)
    ap.add_argument("--train-split", default="train")
    ap.add_argument("--valid-split", default="validation")
    ap.add_argument("--std-norm", action="store_true",
                    help="normalize the log-power inputs with the train statistics")
    ap.add_argument("--stats-h5", default=None,
                    help="statistics file (.h5, or .npz without h5py) for --std-norm; "
                         "default: the builder's <processed>/ntcd_timit/Noisy/"
                         "ntcd_timit_log_power_spec_upsampled_statistics.h5")
    args = ap.parse_args(argv)
    if args.labels != "vad_labels":
        # the LSTM head emits one scalar per frame (the reference's script is
        # VAD-only too, train_audio_net.py:63-66)
        ap.error("train_audio_net is VAD-only (--labels vad_labels)")
    args.mesh = trainer_mesh(args)
    return args


def utterances(proc: str, split: str, args) -> UtteranceDataset:
    """The split's (noisy wav, clean label file) pairs that exist on disk."""
    pairs = ntcd_timit.proc_noisy_clean_pair_dict(proc + "/", split, args.dataset_size,
                                                  args.labels, upsampled=True)
    return UtteranceDataset([
        (os.path.join(proc, noisy), os.path.join(proc, clean)) for noisy, clean in pairs.items()
        if os.path.exists(os.path.join(proc, noisy)) and os.path.exists(os.path.join(proc, clean))])


def main(argv=None) -> list:
    args = parse_args(argv)
    device = resolve_device(args.platform) if args.mesh is None else args.mesh.device
    proc = processed_dir(args)
    stft_cfg = StftConfig(center=True)  # the reference loader's (data_handling.py:126-139)
    train_ds, valid_ds = utterances(proc, args.train_split, args), utterances(
        proc, args.valid_split, args)
    if len(train_ds) == 0:
        raise SystemExit("no training utterances found; run the create_* builders")
    print(f"{len(train_ds)} train / {len(valid_ds)} validation utterances")

    norm = None
    if args.std_norm:
        stats = args.stats_h5 or os.path.join(proc, NOISY_STATS + ".h5")
        norm = read_norm_stats(stats)
        print(f"std-norm from {stats}")

    model = LSTMVad(513, args.hidden, args.num_layers,
                    generator=torch.Generator().manual_seed(args.seed)).to(device)
    opt = adam(model.parameters(), args.learning_rate)
    model_dir = os.path.join(
        args.models_root,
        args.run_name or (f"ntcd_audio_vad_lstm_{args.hidden}x{args.num_layers}"
                          + ("_norm" if args.std_norm else "")))
    return fit_sequence(
        model, opt, make_lstm_vad_step(model, opt, norm=norm, mesh=args.mesh),
        make_lstm_vad_eval(model, norm=norm, mesh=args.mesh), train_ds, valid_ds,
        lambda ds, idx: batch_utterances(ds, idx, stft_cfg, device=device),
        model_dir, prefix="VAD", seed=args.seed, start_epoch=args.start_epoch,
        end_epoch=args.end_epoch, batch_size=args.seq_batch_size, mesh=args.mesh)


if __name__ == "__main__":
    main()
