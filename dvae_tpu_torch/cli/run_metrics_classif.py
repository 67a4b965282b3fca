"""VAD/IBM classifier metrics: accuracy / precision / recall / F1 of stored
classifier outputs against the oracle labels, with CI tables per speaker
(port of the JAX package's ``scripts/run_metrics_classif.py``).

    python -m dvae_tpu_torch.cli.run_metrics_classif --data-root data \\
        --classifier-dir <predict_vad_labels output> [--binarize 0.5] \\
        [--stats-dir <dir>] [--with-figures] [--with-videos]

Mirrors the reference's run_metrics_classif.py:129-136: classifier outputs
are ``*_y_hat_hard.pt`` tensors or ``.npy`` arrays (``predict_vad_labels``
writes them), one per speaker and utterance (the first of a sorted walk,
``.pt`` first, where several conditions hold one). Besides the JAX script's
tables, a last line scores every frame at once, as ``predict_vad_labels``'
``vs oracle:`` line does. Oracle label files and lip videos are ``.h5``
(``h5py``) or ``.npz``. ``--with-figures`` needs ``matplotlib``,
``--with-videos`` ``cv2`` (and ``ffmpeg`` on the PATH to mux the audio
in). The F1 counts and the figures' spectrograms run on the card
unless ``--platform cpu``; everything else is host work."""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from dvae_tpu_torch import viz
from dvae_tpu_torch.cli._family import add_common, processed_dir, y_dim_for
from dvae_tpu_torch.data.catalog import ntcd_timit
from dvae_tpu_torch.data.io import array_file, load_arrays, read_wav
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.enhance.evaluate import load_classifier_labels, load_oracle_labels
from dvae_tpu_torch.eval.stats import compute_stats
from dvae_tpu_torch.models.losses import f1_loss
from dvae_tpu_torch.ops.stft import StftConfig, stft_to_host


def parse_args(argv=None) -> argparse.Namespace:
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.run_metrics_classif", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--classifier-dir", required=True,
                    help="dir with <split>/<spk>/<utt>_y_hat_hard.pt outputs")
    ap.add_argument("--label-suffix", default="_y_hat_hard",
                    help="classifier-output suffix to score; e.g. "
                         "_y_hat_soft or _oracle_y to score the label dumps "
                         "written by evaluate_ntcd_m2_info_vad --save-labels")
    ap.add_argument("--binarize", type=float, default=None, metavar="T",
                    help="threshold soft labels at T before scoring (e.g. "
                         "0.5 for _y_hat_soft dumps); default scores them "
                         "as-is (soft counts)")
    ap.add_argument("--stats-dir", default=None,
                    help="where to write stats.json (default: "
                         "--classifier-dir; useful when scoring artifacts "
                         "in a read-only tree)")
    ap.add_argument("--confidence", type=float, default=0.95)
    ap.add_argument("--with-figures", action="store_true",
                    help="per-utterance mixture/clean/mask figure with the "
                         "classifier metrics in the title, saved next to the "
                         "classifier output as *_hard_mask.png (reference "
                         "run_metrics_classif.py:204-232); needs matplotlib")
    ap.add_argument("--snr", default="-5",
                    help="SNR folder of the mixture drawn in figures")
    ap.add_argument("--noise-type", default="Babble",
                    help="noise folder of the mixture drawn in figures")
    ap.add_argument("--with-videos", action="store_true",
                    help="per-utterance lip-video VAD demos: the upsampled "
                         "67x67 frames with a white bottom-right square on "
                         "active frames, for the oracle labels "
                         "(*_oracle_audio.mp4), the scored classifier "
                         "decisions (*_pred_audio.mp4) and — when a "
                         "*_y_hat_soft sibling exists — the soft posterior "
                         "(*_soft_audio.mp4, intensity-scaled). The working "
                         "version of the reference's commented/unrunnable "
                         "experiment (run_metrics_classif.py:238-294) incl. "
                         "its y_hat_soft TODO (:296); audio is muxed in when "
                         "an ffmpeg binary is available, else the videos are "
                         "silent. VAD labels only (needs a scalar per-frame "
                         "label); needs cv2")
    args = ap.parse_args(argv)
    if args.with_figures:
        viz.require_matplotlib("--with-figures")
    if args.with_videos:
        viz.require_cv2("--with-videos")
    return args


def soft_sibling(args, hard_path: str) -> list:
    """The ``*_y_hat_soft.*`` files beside a scored ``*_y_hat_hard`` file
    (none when another suffix is scored)."""
    if args.label_suffix != "_y_hat_hard":
        return []
    return glob.glob(os.path.splitext(hard_path)[0].replace("_y_hat_hard", "_y_hat_soft")
                     + ".*")


def main(argv=None) -> list:
    args = parse_args(argv)
    device = resolve_device(args.platform)
    proc = processed_dir(args)
    suffix = f"_{args.labels}_upsampled"
    label_files = ntcd_timit.label_files(os.path.join(proc, "ntcd_timit/Clean/test"), suffix)
    if not label_files:
        raise SystemExit(f"no oracle label files under {proc}")

    # one walk over the classifier tree, indexed by (speaker, filename) —
    # not a recursive glob per utterance (O(N x tree) on the full corpus).
    # Sorted walk + .pt-over-.npy preference keeps the pick deterministic
    # across filesystems (cf. evaluate.find_classifier_labels).
    cls_index: dict[tuple, list] = {}
    for dirpath, dirnames, filenames in os.walk(args.classifier_dir):
        dirnames.sort()
        spk_dir = os.path.basename(dirpath)
        for fn in sorted(filenames):
            if args.label_suffix + "." in fn:
                cls_index.setdefault((spk_dir, fn.rsplit(".", 1)[0]), []).append(
                    os.path.join(dirpath, fn))

    rows, speakers, pooled = [], [], ([], [])
    missing = no_video = 0
    for lab_path in label_files:
        rel = os.path.relpath(lab_path, proc)
        spk = rel.split("/")[-2]
        utt = os.path.splitext(os.path.basename(rel))[0].replace(suffix, "")
        cand = sorted(cls_index.get((spk, utt + args.label_suffix), []),
                      key=lambda p: (not p.endswith(".pt"), p))
        if not cand:
            missing += 1
            continue
        y = load_oracle_labels(lab_path)
        # the y_dim hint resolves 2-D orientation exactly — without it an
        # IBM-style (frames, 513) file with < 513 frames would be transposed
        y_hat = load_classifier_labels(cand[0], y_dim_for(args.labels))
        if args.binarize is not None:
            y_hat = (y_hat > args.binarize).astype(np.float32)
        n = min(len(y), len(y_hat))
        # arguments in f1_loss's declared (y_hat, y) order — the reference
        # passes them swapped (run_metrics_classif.py:136), so its printed
        # precision/recall are exchanged
        acc, prec, rec, f1 = f1_loss(torch.as_tensor(y_hat[:n].ravel(), device=device),
                                     torch.as_tensor(y[:n].ravel(), device=device))
        rows.append([float(acc), float(prec), float(rec), float(f1)])
        speakers.append(spk)
        pooled[0].append(y_hat[:n].ravel())
        pooled[1].append(y[:n].ravel())

        if args.with_figures:
            # mixture / clean+oracle-mask / classifier-mask grid, metrics in
            # the title (reference run_metrics_classif.py:204-232)
            import matplotlib

            matplotlib.use("pdf")
            import matplotlib.pyplot as plt

            clean_wav = os.path.join(os.path.dirname(lab_path), utt + ".wav")
            noisy_wav = os.path.join(proc, "ntcd_timit/Noisy", args.noise_type, str(args.snr),
                                     "test", spk, utt + ".wav")
            if os.path.exists(clean_wav) and os.path.exists(noisy_wav):
                s_t, fs = read_wav(clean_wav)
                x_t, _ = read_wav(noisy_wav)
                norm = np.max(np.abs(x_t)) or 1.0
                s_t, x_t = s_t / norm, x_t / norm
                cfg_s = StftConfig()
                sig_items = [
                    (x_t, stft_to_host(x_t, cfg_s, device), None),
                    (s_t, stft_to_host(s_t, cfg_s, device), y),
                    (None, None, y_hat),
                ]
                # the reference also panels the soft posterior
                # (run_metrics_classif.py:204-216) — included when the
                # classifier shipped *_y_hat_soft artifacts
                soft = soft_sibling(args, cand[0])
                if soft:
                    sig_items.append((None, None, load_classifier_labels(soft[0])))
                fig = viz.display_multiple_signals(sig_items, fs=fs)
                fig.suptitle(
                    f"Input SNR = {args.snr} dB \n"
                    f"Noise type = {args.noise_type}, \n"
                    f"Accuracy = {float(acc):.3f},  "
                    f"Precision = {float(prec):.3f},  "
                    f"Recall = {float(rec):.3f},  "
                    f"F1-score = {float(f1):.3f}\n", fontsize=40)
                fig.savefig(os.path.splitext(cand[0])[0] + "_hard_mask.png", dpi=80)
                plt.close(fig)

        if args.with_videos:
            # lip-video VAD demos (the reference's commented experiment; see
            # the flag's help text). The upsampled frames live beside the
            # labels' tree under matlab_raw/<split>/<speaker>/.
            video = array_file(os.path.join(proc, "ntcd_timit/matlab_raw/test", spk,
                                            utt + "_upsampled.h5"))
            if y.shape[-1] != 1 or video is None:
                no_video += 1
            else:
                frames = load_arrays(video, "X")[0]
                clean_wav = os.path.join(os.path.dirname(lab_path), utt + ".wav")
                audio = clean_wav if os.path.exists(clean_wav) else None
                stem = os.path.splitext(cand[0])[0]
                if stem.endswith(args.label_suffix):
                    stem = stem[: -len(args.label_suffix)]
                viz.write_vad_demo_video(frames, y.ravel(), stem + "_oracle_audio.mp4",
                                         audio_wav=audio)
                viz.write_vad_demo_video(frames, y_hat.ravel(), stem + "_pred_audio.mp4",
                                         audio_wav=audio)
                # the reference's "#TODO: make video with y_hat_soft"
                soft = soft_sibling(args, cand[0])
                if soft:
                    viz.write_vad_demo_video(
                        frames, load_classifier_labels(soft[0], 1).ravel(),
                        stem + "_soft_audio.mp4", audio_wav=audio)

    if not rows:
        raise SystemExit(f"no classifier outputs matched under {args.classifier_dir} "
                         f"({missing} missing)")
    if no_video:
        print(f"note: {no_video} utterances skipped for --with-videos "
              f"(no matlab_raw lip video, or non-scalar labels)")
    if missing:
        print(f"note: {missing} utterances had no classifier output")
    stats_dir = args.stats_dir or args.classifier_dir
    try:
        compute_stats(["accuracy", "precision", "recall", "f1"], rows,
                      stats_dir, args.confidence, all_speakers=speakers)
    except OSError as e:
        # scoring shipped artifacts in a read-only tree: the tables were
        # already printed before the final stats.json write failed
        print(f"note: stats.json not written ({e}); pass --stats-dir for a "
              f"writable destination")
    # every scored frame at once, as predict_vad_labels' "vs oracle:" line
    # counts them (the tables average per utterance)
    acc, prec, rec, f1 = f1_loss(*(torch.as_tensor(np.concatenate(p), device=device)
                                   for p in pooled))
    print(f"pooled over {len(rows)} utterances: accuracy={float(acc):.4f} "
          f"precision={float(prec):.4f} recall={float(rec):.4f} f1={float(f1):.4f}")
    return rows


if __name__ == "__main__":
    main()
