"""Predict per-frame VAD labels with a trained classifier (port of the JAX
package's ``scripts/predict_vad_labels.py``).

    python -m dvae_tpu_torch.cli.predict_vad_labels --data-root data \
        --model-dir models/ntcd_audio_vad_lstm_1024x2_norm --std-norm \
        --stats-h5 <...>.npz --snr all

Runs a checkpoint (a ``.pt``: ``--checkpoint``, or the best one of the
modality's prefix in ``--model-dir``) over the catalog's test utterances
and writes ``<stem>_y_hat_hard.npy`` (``soft > --threshold``) and
``<stem>_y_hat_soft.npy`` (the sigmoid), each over the label file's
frames, in the layout ``evaluate_ntcd_m2* --y-source classifier
--classifier-dir <out>`` reads. ``--modality``:

* ``audio`` (default): a ``train_audio_net`` ``LSTMVad`` (prefix ``VAD``).
  ``--source noisy`` (default) predicts from each noisy mixture and mirrors
  the noisy tree (``<out>/ntcd_timit/Noisy/<type>/<snr>/test/<spk>/<utt>``),
  ``--snr`` selecting the condition ('all' = every one); ``--source clean``
  predicts once per utterance from its clean wav (``<out>/ntcd_timit/Clean/
  test/<spk>/<utt>``);
* ``video``: a ``train_video_net`` ``VideoVad`` (``Video_Net``), once per
  utterance from its lip video, on the clean layout: the reference's own
  setup, whose consumed labels came from a lip-video classifier;
* ``av``: a ``train_video_net --modality av`` ``AVVad`` (``AV_Net``), per
  condition from each noisy mixture and its utterance's lip video, on the
  noisy layout.

``--source`` applies to ``audio`` only. ``--hidden`` defaults to 1024 for
audio and 512 for video / av. Utterances whose inputs are missing are
skipped with a count; those whose two outputs exist are skipped unless
``--overwrite``; the rest go in batches of similar input size, an audio or
av batch one STFT power launch on the card (``--platform cpu``: the plain
path). The last lines compare the hard labels with the oracle's (``vs
oracle:``). Label files, lip videos, ``--stats-h5`` and
``--video-stats-h5`` are ``.h5`` or ``.npz``."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dvae_tpu_torch.cli._family import (
    add_common,
    add_shard,
    processed_dir,
    read_norm_stats,
    shard_of,
)
from dvae_tpu_torch.data.av_dataset import AudioVisualDataset, VideoDataset
from dvae_tpu_torch.data.builders import NOISY_STATS, VIDEO_STATS
from dvae_tpu_torch.data.catalog import ntcd_timit
from dvae_tpu_torch.data.datasets import UtteranceDataset
from dvae_tpu_torch.data.io import array_file
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.enhance.evaluate import clean_audio_rel, shard_slice
from dvae_tpu_torch.models import AVVad, LSTMVad, VideoVad
from dvae_tpu_torch.models.losses import f1_loss
from dvae_tpu_torch.ops.stft import StftConfig
from dvae_tpu_torch.train import checkpoint as ckpt
from dvae_tpu_torch.train.sequence import (
    batch_av_utterances,
    batch_utterances,
    batch_video_utterances,
    make_lstm_vad_predict,
)

PREFIX = {"audio": "VAD", "video": "Video_Net", "av": "AV_Net"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.predict_vad_labels", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--model-dir", default=None,
                    help="train_audio_net / train_video_net output dir (the best .pt of "
                         "the modality's prefix is used)")
    ap.add_argument("--checkpoint", default=None, help="a .pt (overrides --model-dir)")
    ap.add_argument("--modality", default="audio", choices=["audio", "video", "av"],
                    help="audio = the LSTM over the wavs; video = the lip-video net; "
                         "av = the audio-visual net")
    ap.add_argument("--hidden", type=int, default=None,
                    help="LSTM width (default: 1024 for audio, 512 for video / av)")
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--emb-dim", type=int, default=128,
                    help="lip-encoder embedding width (video / av)")
    ap.add_argument("--source", default=None, choices=["noisy", "clean"],
                    help="audio only: predict from the noisy mixtures (default; "
                         "per-condition output tree) or from the clean wavs (one file per "
                         "utterance)")
    ap.add_argument("--dataset-type", default="test")
    ap.add_argument("--snr", default="10",
                    help="only this SNR condition for --source noisy ('all' = every one)")
    ap.add_argument("--seq-batch-size", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="hard-decision threshold on the sigmoid posterior")
    ap.add_argument("--std-norm", action="store_true",
                    help="the model was trained with --std-norm")
    ap.add_argument("--stats-h5", default=None,
                    help="audio statistics file (.h5, or .npz without h5py) for "
                         "--std-norm; default: the builder's noisy statistics .h5")
    ap.add_argument("--video-stats-h5", default=None,
                    help="pixel statistics file (.h5 or .npz) for --std-norm with "
                         "--modality video / av; default: the video builder's .h5")
    ap.add_argument("--output-dir", default=None,
                    help="default: <models-root>/predictions/<model>/<ckpt>")
    ap.add_argument("--overwrite", action="store_true",
                    help="predict again where both output files exist")
    add_shard(ap)
    args = ap.parse_args(argv)
    if args.labels != "vad_labels":
        ap.error("predict_vad_labels is VAD-only (--labels vad_labels)")
    if not (args.checkpoint or args.model_dir):
        ap.error("need --checkpoint or --model-dir")
    if args.modality == "audio":
        args.source = args.source or "noisy"
    elif args.source is not None:
        ap.error("--source applies to --modality audio only (video is "
                 "per-utterance, av per-condition by construction)")
    if args.hidden is None:
        args.hidden = 1024 if args.modality == "audio" else 512
    shard_of(args)
    return args


def _norm(proc: str, args):
    """``norm`` of ``--std-norm`` for the modality, or None."""
    if not args.std_norm:
        return None
    audio_norm = video_norm = None
    if args.modality in ("audio", "av"):
        stats = args.stats_h5 or os.path.join(proc, NOISY_STATS + ".h5")
        audio_norm = read_norm_stats(stats)
        print(f"audio std-norm from {stats}")
    if args.modality in ("video", "av"):
        vstats = args.video_stats_h5 or os.path.join(proc, VIDEO_STATS + ".h5")
        video_norm = read_norm_stats(vstats)
        print(f"video std-norm from {vstats}")
    return {"audio": audio_norm, "video": video_norm,
            "av": (audio_norm, video_norm)}[args.modality]


def _model(args):
    if args.modality == "audio":
        return LSTMVad(513, args.hidden, args.num_layers)
    if args.modality == "video":
        return VideoVad(args.hidden, args.num_layers, args.emb_dim)
    return AVVad(513, args.hidden, args.num_layers, args.emb_dim)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.platform)
    proc = processed_dir(args)
    stft_cfg = StftConfig(center=True)  # the trainer's

    def video_rel_of(label_rel):
        return ntcd_timit.video_h5_rel(label_rel, args.labels)

    items = list(ntcd_timit.proc_noisy_clean_pair_dict(
        proc + "/", args.dataset_type, args.dataset_size, args.labels, upsampled=True).items())
    if args.modality == "av" or args.source == "noisy":
        if args.snr != "all":
            items = [it for it in items if it[0].split("/")[-4] == str(args.snr)]
        # (input_rel, label_rel, output_rel_stem)
        todo = [(n, c, os.path.splitext(n)[0]) for n, c in items]
    else:
        # several conditions map to one clean utterance: one prediction each,
        # from its clean wav or its lip video, on the clean layout
        seen = {}
        for _, clean_rel in items:
            wav_rel = clean_audio_rel(clean_rel, args.labels)
            inp = video_rel_of(clean_rel) if args.modality == "video" else wav_rel
            seen.setdefault(wav_rel, (inp, clean_rel, os.path.splitext(wav_rel)[0]))
        todo = sorted(seen.values())
    # sharded before the skip filter, so that membership survives restarts
    todo = shard_slice(todo, shard_of(args))

    norm = _norm(proc, args)
    model = _model(args)
    path = args.checkpoint or ckpt.best_checkpoint(args.model_dir, prefix=PREFIX[args.modality])
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    model.to(device)
    print(f"loaded {path}")
    predict = make_lstm_vad_predict(model, norm=norm)

    model_name = os.path.basename(os.path.normpath(args.model_dir or os.path.dirname(str(path))))
    out_root = args.output_dir or os.path.join(
        args.models_root, "predictions", model_name,
        os.path.splitext(os.path.basename(str(path)))[0])

    def out_paths(stem):
        base = os.path.join(out_root, stem)
        return base + "_y_hat_hard.npy", base + "_y_hat_soft.npy"

    def on_disk(rel):
        """The input ``rel`` names: a wav as it is, a lip video under either
        suffix; None where it is missing."""
        p = os.path.join(proc, rel)
        if rel.endswith(".wav"):
            return p if os.path.exists(p) else None
        return array_file(p)

    def inputs_of(t):
        """Every file an item needs: its input (wav or lip video; the
        catalog names the whole grid, on disk or not), and for av the lip
        video."""
        paths = [on_disk(t[0])]
        if args.modality == "av":
            paths.append(on_disk(video_rel_of(t[1])))
        return paths

    have = [(t, ins) for t in todo if None not in (ins := inputs_of(t))]
    if len(have) < len(todo):
        print(f"skipping {len(todo) - len(have)} utterances with missing input files")
    if not args.overwrite:
        have = [(t, ins) for t, ins in have
                if not all(os.path.exists(p) for p in out_paths(t[2]))]
    # batches of similar length: the input's size orders by duration for PCM
    # wavs and uncompressed videos alike
    have.sort(key=lambda h: (os.path.getsize(h[1][0]), h[0][0]))
    todo = [t for t, _ in have]

    if args.modality == "audio":
        ds = UtteranceDataset([(ins[0], os.path.join(proc, t[1])) for t, ins in have])

        def batcher(idx):
            return batch_utterances(ds, idx, stft_cfg, device=device)
    elif args.modality == "video":
        ds = VideoDataset([(ins[0], os.path.join(proc, t[1])) for t, ins in have])

        def batcher(idx):
            return batch_video_utterances(ds, idx, device=device)
    else:
        ds = AudioVisualDataset([(ins[0], ins[1], os.path.join(proc, t[1])) for t, ins in have])

        def batcher(idx):
            return batch_av_utterances(ds, idx, stft_cfg, device=device)
    n_done, hard_all, oracle_all = 0, [], []
    for s in range(0, len(todo), args.seq_batch_size):
        idx = range(s, min(s + args.seq_batch_size, len(todo)))
        xb, yb, mb = batcher(idx)
        probs, yb, mb = (t.cpu().numpy() for t in (predict(xb), yb, mb))
        for j, i in enumerate(idx):
            n = int(np.sum(mb[j]))
            soft = probs[j, :n].astype(np.float32)
            hard = (soft > args.threshold).astype(np.float32)
            hard_p, soft_p = out_paths(todo[i][2])
            os.makedirs(os.path.dirname(hard_p), exist_ok=True)
            np.save(soft_p, soft)
            np.save(hard_p, hard)
            hard_all.append(hard)
            oracle_all.append(yb[j, :n])
            n_done += 1
        print(f"predicted {n_done}/{len(todo)}")

    if hard_all:
        acc, prec, rec, f1 = f1_loss(torch.from_numpy(np.concatenate(hard_all)),
                                     torch.from_numpy(np.concatenate(oracle_all)))
        print(f"vs oracle: accuracy={float(acc):.4f} precision={float(prec):.4f} "
              f"recall={float(rec):.4f} f1={float(f1):.4f}")
    print(f"done: {n_done} utterances -> {out_root}")
    return n_done


if __name__ == "__main__":
    main()
