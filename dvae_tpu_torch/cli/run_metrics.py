"""Compute SI-SDR / ESTOI / PESQ over enhanced outputs and print the 95%-CI
tables grouped by SNR / noise type / stationarity / speaker (port of the JAX
package's ``scripts/run_metrics.py``).

    python -m dvae_tpu_torch.cli.run_metrics --data-root data \\
        --model-output-dir <evaluate_ntcd_* output dir> [--suffix _y_hat_hard] \\
        [--classifier-dir <predict_vad_labels output>] [--with-figures]
    python -m dvae_tpu_torch.cli.run_metrics --data-root data --score-input \\
        [--model-output-dir <dir>]

Mirrors the reference's run_metrics.py: 0.05 s edge trim, condition parsing
from the processed-noisy path, per-condition tables via ``compute_stats``,
optional per-utterance mixture/clean/estimate figures (run_metrics.py:
171-236, needs ``matplotlib``) and in-sweep classifier-F1 columns via
``--classifier-dir`` (run_metrics.py:144-169). PESQ always scores — the
licensed wheel when importable, else the native P.862.2 implementation
(``dvae_tpu_torch.eval.pesq_native``); POLQA stays gated on its proprietary
package. Writes ``stats.json`` in the model output dir (``stats_input.json``
with ``--score-input``). Scoring is host numpy; the F1 counts and the
figures' spectrograms run on the card unless ``--platform cpu``. Oracle
label files are ``.h5`` (``h5py``) or ``.npz``."""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from dvae_tpu_torch import viz
from dvae_tpu_torch.cli._family import add_common, processed_dir, y_dim_for
from dvae_tpu_torch.data.catalog import ntcd_timit
from dvae_tpu_torch.data.io import read_wav
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.enhance.evaluate import (
    classifier_label_candidates,
    clean_audio_rel,
    load_classifier_labels,
    load_oracle_labels,
)
from dvae_tpu_torch.eval.pesq import pesq as pesq_fn
from dvae_tpu_torch.eval.pesq import pesq_available, pesq_wheel_available
from dvae_tpu_torch.eval.si_sdr import si_sdr_leroux
from dvae_tpu_torch.eval.stats import compute_stats, mean_confidence_interval
from dvae_tpu_torch.eval.stoi import stoi
from dvae_tpu_torch.models.losses import f1_loss
from dvae_tpu_torch.ops.stft import StftConfig, stft_to_host

STATIONARY = {"Car", "White"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = add_common(argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.run_metrics", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--model-output-dir", default=None,
                    help="dir holding the enhanced <...>_s_est.wav tree "
                         "(required unless --score-input)")
    ap.add_argument("--score-input", action="store_true",
                    help="score the raw noisy MIXTURE against the clean "
                         "reference instead of enhanced outputs — the "
                         "'noisy input' baseline rows of the paper's tables "
                         "(reference's commented variants at "
                         "run_metrics.py:130,134,138). With "
                         "--model-output-dir the tables are saved as "
                         "stats_input.json there (stats.json is never "
                         "overwritten by baselines)")
    ap.add_argument("--suffix", default="",
                    help="estimate suffix, e.g. _y_hat_hard or _oracle_y")
    ap.add_argument("--est-prefix", default="",
                    help="estimate prefix before _s_est, e.g. _clean_z_nomcem "
                         "(scores the oracle-latent ablation outputs the "
                         "evaluate CLIs write with --ablation)")
    ap.add_argument("--snr", default=None)
    ap.add_argument("--confidence", type=float, default=0.95)
    ap.add_argument("--with-figures", action="store_true",
                    help="per-utterance mixture/clean/estimate figure "
                         "(wave + spectrogram + mask grid, reference "
                         "run_metrics.py:171-236); needs matplotlib")
    ap.add_argument("--classifier-dir", default=None,
                    help="dir with <spk>/<utt>_y_hat_hard.{pt,npy} classifier "
                         "outputs: adds accuracy/precision/recall/f1 columns "
                         "to the sweep (reference run_metrics.py:144-169)")
    ap.add_argument("--polqa", action="store_true",
                    help="batch POLQA mode (reference main_polqa, "
                         "run_metrics.py:337): requires the proprietary "
                         "uhh_sp package; pairs shorter than 3 s are padded "
                         "copies scored as a separate batch")
    args = ap.parse_args(argv)
    if not args.score_input and not args.model_output_dir:
        ap.error("--model-output-dir is required unless --score-input")
    if args.score_input and (args.with_figures or args.polqa):
        ap.error("--score-input composes with neither --with-figures nor "
                 "--polqa (score the mixture with the plain metric sweep)")
    if args.polqa and (args.with_figures or args.classifier_dir):
        ap.error("--polqa is a dedicated batch mode (reference main_polqa) "
                 "and ignores --with-figures/--classifier-dir; run the "
                 "plain sweep for those")
    if args.with_figures:
        viz.require_matplotlib("--with-figures")
    return args


def est_name(args) -> str:
    return f"{args.est_prefix}_s_est{args.suffix}"


def run_polqa(args, proc: str, items) -> None:
    """Batch POLQA over (clean, s_est) pairs — reference main_polqa
    (run_metrics.py:337-452): short pairs padded to 3 s, scored as a
    separate extended batch, overall mean + CI printed."""
    from dvae_tpu_torch.eval.pesq import polqa, polqa_available, polqa_prepare_pairs

    if not polqa_available():
        raise SystemExit(
            "POLQA requires the proprietary uhh_sp package (ITU-T P.863),"
            " which is not installed."
        )
    wav_pairs, missing = [], 0
    for noisy_rel, clean_rel in items:
        est = os.path.join(args.model_output_dir,
                           os.path.splitext(noisy_rel)[0] + est_name(args) + ".wav")
        ref = os.path.join(proc, clean_audio_rel(clean_rel, args.labels))
        if os.path.exists(est) and os.path.exists(ref):
            wav_pairs.append((ref, est))
        else:
            missing += 1
    if not wav_pairs:
        raise SystemExit(
            f"no (clean, {est_name(args)}) pairs under {args.model_output_dir}")
    if missing:
        print(f"note: {missing}/{len(items)} utterances missing enhanced "
              f"output or clean reference, skipped")
    normal, extended = polqa_prepare_pairs(
        wav_pairs, pad_dir=os.path.join(args.model_output_dir, "polqa_3sec"))
    scores = []
    if normal:
        scores += list(polqa([r for r, _ in normal], [d for _, d in normal]))
    if extended:
        print(f"note: {len(extended)} pairs < 3 s scored from padded copies")
        scores += list(polqa([r for r, _ in extended], [d for _, d in extended]))
    scores = np.asarray(scores, np.float64)
    n_nan = int(np.isnan(scores).sum())
    if n_nan:  # the reference drops NaN POLQA results (run_metrics.py:480-486)
        print(f"note: {n_nan} NaN POLQA scores dropped")
        scores = scores[~np.isnan(scores)]
    if scores.size == 0:
        raise SystemExit("POLQA returned no valid scores")
    mean, ci = mean_confidence_interval(scores, args.confidence)
    print(f"polqa      {mean:<10.3f} {ci:<10.3f} (n={len(scores)})")


def classifier_index(classifier_dir: str) -> dict:
    """{(speaker dir, utterance): path} of every ``*_y_hat_hard.{pt,npy}``
    under ``classifier_dir``, one tree walk, sorted with .pt first: glob's
    scandir order is filesystem-dependent and setdefault keeps the first
    hit, so the pick is the same on every machine (cf.
    ``evaluate.find_classifier_labels``)."""
    index = {}
    for pat in ("*_y_hat_hard.pt", "*_y_hat_hard.npy"):
        for path in sorted(glob.glob(os.path.join(classifier_dir, "**", pat),
                                     recursive=True)):
            spk_dir = os.path.basename(os.path.dirname(path))
            base = os.path.basename(path).split("_y_hat_hard")[0]
            index.setdefault((spk_dir, base), path)
    return index


def main(argv=None) -> dict | None:
    args = parse_args(argv)
    proc = processed_dir(args)
    pairs = ntcd_timit.proc_noisy_clean_pair_dict(
        proc + "/", "test", args.dataset_size, args.labels, upsampled=True)
    items = list(pairs.items())
    if args.snr and args.snr != "all":
        items = [it for it in items if it[0].split("/")[-4] == args.snr]

    if args.polqa:
        run_polqa(args, proc, items)
        return None

    device = resolve_device(args.platform)
    use_pesq = pesq_available()
    keys = ["si_sdr", "estoi"] + (["pesq"] if use_pesq else [])
    if args.classifier_dir:
        keys += ["accuracy", "precision", "recall", "f1"]
    rows, snrs, noises, speakers, stationarities = [], [], [], [], []
    missing = 0
    missing_classif = 0
    missing_oracle = 0
    clean_cache = {}
    oracle_cache = {}
    classif_index = None  # built lazily on first use (one tree walk)

    for noisy_rel, clean_rel in items:
        if args.score_input:
            est_path = os.path.join(proc, noisy_rel)  # the mixture itself
        else:
            est_path = os.path.join(args.model_output_dir,
                                    os.path.splitext(noisy_rel)[0] + est_name(args) + ".wav")
        if not os.path.exists(est_path):
            missing += 1
            continue
        parts = noisy_rel.split("/")
        noise_type, snr_db, speaker = parts[-5], int(parts[-4]), parts[-2]
        utt = os.path.splitext(os.path.basename(noisy_rel))[0]

        # each clean wav recurs under every (noise x SNR) condition of the
        # sweep (~25x in the full grid): cache the reads
        if clean_rel not in clean_cache:
            clean_cache[clean_rel] = read_wav(
                os.path.join(proc, clean_audio_rel(clean_rel, args.labels)))
        s_t, fs = clean_cache[clean_rel]
        s_hat_t, _ = read_wav(est_path)

        off = int(0.05 * fs)  # edge-burst trim (run_metrics.py:118-121)
        L = min(len(s_t), len(s_hat_t))
        if L <= 2 * off + 1:
            # a truncated estimate (e.g. a kill mid-write that resume-by-skip
            # then treats as done) must not abort the sweep — same contract
            # as the PESQ guard below
            print(f"note: metrics skipped for {noisy_rel}: estimate too "
                  f"short after edge trims ({L} samples)")
            continue
        s_t, s_hat_t = s_t[off : L - off], s_hat_t[off : L - off]

        y_hat_hard = None
        if args.classifier_dir:
            # classifier-F1 inside the sweep (reference run_metrics.py:144-169),
            # the arguments in f1_loss's declared (y_hat, y) order: the
            # reference passes them swapped (:169), so its printed precision
            # is recall and vice versa. Accuracy and F1 are symmetric.
            if classif_index is None:  # one tree walk, not one per utterance
                classif_index = classifier_index(args.classifier_dir)
            # condition-mirrored/direct layouts first (this utterance's OWN
            # noise/SNR condition beats a same-named file from another), then
            # the recursive index
            cand = next((p for p in classifier_label_candidates(
                args.classifier_dir, speaker, utt,
                rel_dir=os.path.dirname(noisy_rel)) if os.path.exists(p)),
                None) or classif_index.get((speaker, utt))
            if cand:
                # the y_dim hint resolves 2-D orientation exactly — without
                # it an IBM-style (frames, 513) file with < 513 frames would
                # be transposed by the shape heuristic
                y_hat_hard = load_classifier_labels(cand, y_dim_for(args.labels))
            else:
                missing_classif += 1

        row = [si_sdr_leroux(s_hat_t, s_t), stoi(s_t, s_hat_t, fs, extended=True)]
        if use_pesq:
            try:
                row.append(pesq_fn(fs, s_t, s_hat_t, "wb"))
            except ValueError as e:
                # one degenerate utterance (e.g. truncated wav shorter than a
                # PESQ frame after the edge trims) must not abort the sweep;
                # NaN rows are excluded per-metric by compute_stats
                print(f"note: pesq skipped for {noisy_rel}: {e}")
                row.append(np.nan)
        y_oracle = None
        if args.classifier_dir or args.with_figures:
            # like clean_cache above: the same clean utterance's labels
            # recur under every (noise x SNR) condition of the sweep
            if clean_rel not in oracle_cache:
                try:
                    oracle_cache[clean_rel] = load_oracle_labels(os.path.join(proc, clean_rel))
                except (FileNotFoundError, OSError):
                    oracle_cache[clean_rel] = None
                    missing_oracle += 1
            y_oracle = oracle_cache[clean_rel]
        if args.classifier_dir:
            if y_hat_hard is not None and y_oracle is not None:
                n = min(len(y_oracle), len(y_hat_hard))
                acc, prec, rec, f1 = f1_loss(
                    torch.as_tensor(y_hat_hard[:n].ravel(), device=device),
                    torch.as_tensor(y_oracle[:n].ravel(), device=device))
                row += [float(acc), float(prec), float(rec), float(f1)]
            else:
                row += [np.nan] * 4

        if args.with_figures:
            # mixture / clean / estimate grid with oracle + classifier masks
            # (reference run_metrics.py:171-236)
            import matplotlib

            matplotlib.use("pdf")
            import matplotlib.pyplot as plt

            x_t, _ = read_wav(os.path.join(proc, noisy_rel))
            x_t = x_t[off : L - off]
            cfg_s = StftConfig()
            # stft_to_host already returns the (n_frames, n_bins) layout viz wants
            sig_items = [
                (x_t, stft_to_host(x_t, cfg_s, device), None),
                (s_t, stft_to_host(s_t, cfg_s, device), y_oracle),
                (s_hat_t, stft_to_host(s_hat_t, cfg_s, device), y_hat_hard),
            ]
            fig = viz.display_multiple_signals(sig_items, fs=fs)
            fig.suptitle(f"Input SNR = {snr_db:.1f} dB \n"
                         f"SI-SDR = {row[0]:.1f} dB.", fontsize=40)
            fig.savefig(os.path.splitext(est_path)[0] + "_fig.png", dpi=80)
            plt.close(fig)

        rows.append(row)
        snrs.append(snr_db)
        noises.append(noise_type)
        speakers.append(speaker)
        stationarities.append(
            "Stationary noise" if noise_type in STATIONARY else "Nonstationary noise")

    if not rows:
        where = proc if args.score_input else args.model_output_dir
        hint = (
            f"looked for <dir>/ntcd_timit/Noisy/<type>/<snr>/test/...{est_name(args)}.wav "
            f"for {len(items)} catalog entries ({missing} missing)"
        )
        if args.score_input:
            hint = (f"looked for the mixtures themselves for {len(items)} "
                    f"catalog entries ({missing} missing)")
        if not items:
            hint = (f"the catalog produced no entries for snr={args.snr!r}, "
                    f"labels={args.labels!r} — check --snr/--labels")
        raise SystemExit(f"no scorable files found under {where}: {hint}")
    if missing:
        print(f"note: {missing} utterances missing enhanced output, skipped")
    if missing_oracle:
        print(f"note: {missing_oracle} utterances had unreadable oracle "
              f"labels (NaN classifier columns)")
    if missing_classif:
        print(f"note: {missing_classif} utterances missing classifier output "
              f"(excluded from the accuracy/.../f1 columns)")
    if not pesq_wheel_available():
        print("note: PESQ scored by the native P.862.2 implementation "
              "(licensed wheel not installed; see dvae_tpu_torch.eval.pesq_native)")

    result = compute_stats(
        keys, rows, None if args.score_input else args.model_output_dir,
        args.confidence, all_snr_db=np.asarray(snrs), all_noise_types=noises,
        all_speakers=speakers, all_noise_stationarities=stationarities)
    if args.score_input and args.model_output_dir:
        # never clobber an enhanced run's stats.json with mixture baselines
        dest = os.path.join(args.model_output_dir, "stats_input.json")
        with open(dest, "w") as f:
            json.dump(result, f, indent=1)
        print(f"baseline stats -> {dest}")
    return result


if __name__ == "__main__":
    main()
