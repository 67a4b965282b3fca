"""Predict per-frame VAD labels with a trained audio LSTM classifier (port
of the JAX package's ``scripts/predict_vad_labels.py``, ``--modality
audio``).

    python -m dvae_tpu_torch.cli.predict_vad_labels --data-root data \\
        --model-dir models/ntcd_audio_vad_lstm_1024x2_norm --std-norm \\
        --stats-h5 <...>.npz --snr all

Runs a ``train_audio_net`` checkpoint (a ``.pt``: ``--checkpoint``, or the
best ``VAD`` one in ``--model-dir``) over the catalog's test utterances and
writes ``<stem>_y_hat_hard.npy`` (``soft > --threshold``) and
``<stem>_y_hat_soft.npy`` (the sigmoid), each over the label file's
frames, in the layout ``evaluate_ntcd_m2* --y-source classifier
--classifier-dir <out>`` reads. ``--source noisy`` (default) predicts from
each noisy mixture and mirrors the noisy tree
(``<out>/ntcd_timit/Noisy/<type>/<snr>/test/<spk>/<utt>``), ``--snr``
selecting the condition ('all' = every one); ``--source clean`` predicts
once per utterance from its clean wav (``<out>/ntcd_timit/Clean/test/
<spk>/<utt>``). Utterances whose input is missing are skipped with a count;
those whose two outputs exist are skipped unless ``--overwrite``; the rest
go in batches of similar length, each one STFT power launch on the card
(``--platform cpu``: the plain path). The last lines compare the hard
labels with the oracle's (``vs oracle:``). The label files are ``.h5`` or
``.npz``, and so is ``--stats-h5``. Not ported: ``--modality video|av``
(ROADMAP A13.3), parse errors."""

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
from dvae_tpu_torch.data.builders import NOISY_STATS
from dvae_tpu_torch.data.catalog import ntcd_timit
from dvae_tpu_torch.data.datasets import UtteranceDataset
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.enhance.evaluate import clean_audio_rel, shard_slice
from dvae_tpu_torch.models import LSTMVad
from dvae_tpu_torch.models.losses import f1_loss
from dvae_tpu_torch.ops.stft import StftConfig
from dvae_tpu_torch.train import checkpoint as ckpt
from dvae_tpu_torch.train.sequence import batch_utterances, make_lstm_vad_predict


def parse_args(argv=None) -> argparse.Namespace:
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.predict_vad_labels", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--model-dir", default=None,
                    help="train_audio_net output dir (the best VAD .pt is used)")
    ap.add_argument("--checkpoint", default=None, help="a .pt (overrides --model-dir)")
    ap.add_argument("--modality", default="audio", choices=["audio", "video", "av"],
                    help="audio = the LSTM over the wavs; video and av are not ported")
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--source", default="noisy", choices=["noisy", "clean"],
                    help="predict from the noisy mixtures (per-condition output tree) or "
                         "from the clean wavs (one file per utterance)")
    ap.add_argument("--dataset-type", default="test")
    ap.add_argument("--snr", default="10",
                    help="only this SNR condition for --source noisy ('all' = every one)")
    ap.add_argument("--seq-batch-size", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="hard-decision threshold on the sigmoid posterior")
    ap.add_argument("--std-norm", action="store_true",
                    help="the model was trained with --std-norm")
    ap.add_argument("--stats-h5", default=None,
                    help="statistics file (.h5, or .npz without h5py) for --std-norm; "
                         "default: the builder's noisy statistics .h5")
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
    if args.modality != "audio":
        ap.error(f"--modality {args.modality}: the lip-video and audio-visual "
                 "classifiers are not ported yet (ROADMAP A13.3)")
    shard_of(args)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.platform)
    proc = processed_dir(args)
    stft_cfg = StftConfig(center=True)  # the trainer's

    items = list(ntcd_timit.proc_noisy_clean_pair_dict(
        proc + "/", args.dataset_type, args.dataset_size, args.labels, upsampled=True).items())
    if args.source == "noisy":
        if args.snr != "all":
            items = [it for it in items if it[0].split("/")[-4] == str(args.snr)]
        # (input_rel, label_rel, output_rel_stem)
        todo = [(n, c, os.path.splitext(n)[0]) for n, c in items]
    else:
        # several conditions map to one clean utterance: one prediction each
        seen = {}
        for _, clean_rel in items:
            wav_rel = clean_audio_rel(clean_rel, args.labels)
            seen.setdefault(wav_rel, (wav_rel, clean_rel, os.path.splitext(wav_rel)[0]))
        todo = sorted(seen.values())
    # sharded before the skip filter, so that membership survives restarts
    todo = shard_slice(todo, shard_of(args))

    norm = None
    if args.std_norm:
        stats = args.stats_h5 or os.path.join(proc, NOISY_STATS + ".h5")
        norm = read_norm_stats(stats)
        print(f"audio std-norm from {stats}")

    model = LSTMVad(513, args.hidden, args.num_layers)
    path = args.checkpoint or ckpt.best_checkpoint(args.model_dir, prefix="VAD")
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

    # the catalog names the whole grid, on disk or not
    have = [t for t in todo if os.path.exists(os.path.join(proc, t[0]))]
    if len(have) < len(todo):
        print(f"skipping {len(todo) - len(have)} utterances with missing input files")
    todo = have
    if not args.overwrite:
        todo = [t for t in todo if not all(os.path.exists(p) for p in out_paths(t[2]))]
    # batches of similar length: a PCM wav's size orders by duration
    todo.sort(key=lambda t: (os.path.getsize(os.path.join(proc, t[0])), t[0]))

    ds = UtteranceDataset([(os.path.join(proc, w), os.path.join(proc, lab))
                           for w, lab, _ in todo])
    n_done, hard_all, oracle_all = 0, [], []
    for s in range(0, len(todo), args.seq_batch_size):
        idx = range(s, min(s + args.seq_batch_size, len(todo)))
        xb, yb, mb = batch_utterances(ds, idx, stft_cfg, device=device)
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
