"""Train the lip-video or the audio-visual voice-activity classifier (port
of the JAX package's ``scripts/train_video_net.py``).

    python -m dvae_tpu_torch.cli.train_video_net --data-root data \\
        --modality av --std-norm --video-stats-h5 <...>.npz --stats-h5 <...>.npz

``--modality video``: ``VideoVad(--hidden, --num-layers, --emb-dim)`` over
the 62.5 fps lip videos that ``create_video_train_files`` writes, paired
with their clean label files. ``--modality av``: ``AVVad(513, ...)`` over
each noisy mixture's log-power spectrogram (``StftConfig(center=True)``,
one STFT power launch per batch on the card) beside its utterance's lip
video, the triples of the reference's AV loader (noisy wav, clean label
file, the video by the Clean <-> matlab_raw substitution). Both train on
the length-masked BCE (``train/sequence.py::fit_sequence``), one
checkpoint per epoch, prefix ``Video_Net`` / ``AV_Net``, under
``<models-root>/ntcd_<modality>_vad_<hidden>x<layers>[_norm]``. Videos,
label and statistics files are ``.h5`` or ``.npz`` (a file is found under
either suffix). ``--std-norm`` normalizes the pixels with
``--video-stats-h5`` and, for ``av``, the log power with ``--stats-h5``;
their defaults are the ``.h5`` files the JAX builders write, so a machine
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
from dvae_tpu_torch.data.av_dataset import AudioVisualDataset, VideoDataset
from dvae_tpu_torch.data.builders import NOISY_STATS, VIDEO_STATS
from dvae_tpu_torch.data.catalog import ntcd_timit
from dvae_tpu_torch.data.io import array_file
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.models import AVVad, VideoVad
from dvae_tpu_torch.ops.stft import StftConfig
from dvae_tpu_torch.train.sequence import (
    batch_av_utterances,
    batch_video_utterances,
    fit_sequence,
    make_lstm_vad_eval,
    make_lstm_vad_step,
)
from dvae_tpu_torch.train.steps import adam


def parse_args(argv=None) -> argparse.Namespace:
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.train_video_net", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--modality", default="video", choices=["video", "av"])
    ap.add_argument("--learning-rate", type=float, default=1e-4)
    ap.add_argument("--start-epoch", type=int, default=1)
    ap.add_argument("--end-epoch", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run-name", default=None, help="override the auto model dir name")
    add_trainer_parallel(ap)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--emb-dim", type=int, default=128, help="lip-encoder embedding width")
    ap.add_argument("--seq-batch-size", type=int, default=16)
    ap.add_argument("--train-split", default="train")
    ap.add_argument("--valid-split", default="validation")
    ap.add_argument("--std-norm", action="store_true",
                    help="normalize the lip pixels (and for --modality av the noisy log "
                         "power) with the builders' train statistics")
    ap.add_argument("--video-stats-h5", default=None,
                    help="pixel statistics file (.h5, or .npz without h5py) for "
                         "--std-norm; default: the builder's <processed>/ntcd_timit/"
                         "matlab_raw/ntcd_timit_upsampled_statistics.h5")
    ap.add_argument("--stats-h5", default=None,
                    help="audio statistics file (.h5 or .npz) for --modality av "
                         "--std-norm; default: the noisy log-power statistics .h5")
    args = ap.parse_args(argv)
    if args.labels != "vad_labels":
        # one scalar per frame: a 513-bin IBM label would flatten into the batch
        ap.error("train_video_net is VAD-only (--labels vad_labels)")
    args.mesh = trainer_mesh(args)
    return args


def datasets(proc: str, split: str, args):
    """The split's ``VideoDataset`` (lip video, label file) pairs or
    ``AudioVisualDataset`` (noisy wav, lip video, label file) triples whose
    files exist."""
    if args.modality == "video":
        video_rel, _ = ntcd_timit.proc_video_audio_pair_dict(
            proc + "/", split, labels=args.labels, upsampled=True)
        pairs = []
        for v in video_rel:
            lab = array_file(os.path.join(proc, ntcd_timit.label_h5_rel(v, args.labels)))
            if lab is not None:
                pairs.append((os.path.join(proc, v), lab))
        return VideoDataset(pairs)
    noisy_label = ntcd_timit.proc_noisy_clean_pair_dict(
        proc + "/", split, args.dataset_size, args.labels, upsampled=True)
    triples = []
    for noisy_rel, label_rel in noisy_label.items():
        wav = os.path.join(proc, noisy_rel)
        vid = array_file(os.path.join(proc, ntcd_timit.video_h5_rel(label_rel, args.labels)))
        if os.path.exists(wav) and vid is not None:
            triples.append((wav, vid, os.path.join(proc, label_rel)))
    return AudioVisualDataset(triples)


def std_norm(proc: str, args):
    """``norm`` of ``--std-norm``: the pixel (mean, std), and for ``av`` the
    pair (audio, pixel); None without the flag."""
    if not args.std_norm:
        return None
    vstats = args.video_stats_h5 or os.path.join(proc, VIDEO_STATS + ".h5")
    video_norm = read_norm_stats(vstats)
    print(f"video std-norm from {vstats}")
    if args.modality == "video":
        return video_norm
    astats = args.stats_h5 or os.path.join(proc, NOISY_STATS + ".h5")
    audio_norm = read_norm_stats(astats)
    print(f"audio std-norm from {astats}")
    return audio_norm, video_norm


def main(argv=None) -> list:
    args = parse_args(argv)
    device = resolve_device(args.platform) if args.mesh is None else args.mesh.device
    proc = processed_dir(args)
    stft_cfg = StftConfig(center=True)  # the reference loader's (data_handling.py:126-139)
    train_ds, valid_ds = datasets(proc, args.train_split, args), datasets(
        proc, args.valid_split, args)
    if len(train_ds) == 0:
        raise SystemExit("no training utterances found; run the create_* builders")
    print(f"{len(train_ds)} train / {len(valid_ds)} validation utterances")
    norm = std_norm(proc, args)

    gen = torch.Generator().manual_seed(args.seed)
    if args.modality == "video":
        model = VideoVad(args.hidden, args.num_layers, args.emb_dim, generator=gen)
        prefix = "Video_Net"  # the reference's own naming, train_audio_net.py:368

        def batcher(ds, idx):
            return batch_video_utterances(ds, idx, device=device)
    else:
        model = AVVad(513, args.hidden, args.num_layers, args.emb_dim, generator=gen)
        prefix = "AV_Net"

        def batcher(ds, idx):
            return batch_av_utterances(ds, idx, stft_cfg, device=device)
    model.to(device)
    opt = adam(model.parameters(), args.learning_rate)
    model_dir = os.path.join(
        args.models_root,
        args.run_name or (f"ntcd_{args.modality}_vad_{args.hidden}x{args.num_layers}"
                          + ("_norm" if args.std_norm else "")))
    return fit_sequence(
        model, opt, make_lstm_vad_step(model, opt, norm=norm, mesh=args.mesh),
        make_lstm_vad_eval(model, norm=norm, mesh=args.mesh), train_ds, valid_ds, batcher,
        model_dir, prefix=prefix, seed=args.seed, start_epoch=args.start_epoch,
        end_epoch=args.end_epoch, batch_size=args.seq_batch_size, mesh=args.mesh)


if __name__ == "__main__":
    main()
