"""Audio vs video vs audio-visual VAD: the fusion study (port of the JAX
package's ``scripts/av_fusion_study.py``).

    python -m dvae_tpu_torch.cli.av_fusion_study --data-root data \\
        --models-root models --train --epochs 60 \\
        --enhance-model-dir models/ntcd_M2_VAD_nonorm_... \\
        --out evidence/av_fusion_matrix.json

1. ``--train``: trains the three VADs (``train_audio_net``,
   ``train_video_net --modality video|av``) on the same split at matched
   budgets (hidden, emb, layers, epochs, seed);
2. predicts per-frame labels for every test utterance per noise condition
   (``predict_vad_labels --modality audio|video|av``: audio and AV read the
   condition's noisy mixtures, video the lip videos);
3. reports F1 / precision / recall per noise condition against the oracle
   VAD labels (read through ``data/io.py``, ``.h5`` or ``.npz``), scored by
   ``models/losses.py::f1_loss``;
4. ``--enhance-model-dir``: label-conditioned enhancement
   (``evaluate_ntcd_m2 --y-source classifier``) per modality against the
   oracle labels, scored SI-SDR / ESTOI / native wideband PESQ against the
   clean utterances (``eval/``).

Each step is a process of the port's CLIs (``python -m
dvae_tpu_torch.cli.<name>``). The noise grid is the catalog's, so a
``--snr`` off it fails before any training. The budgets recorded are those
the model directories' checkpoints trained, never the flags'. The
trainers, predictors and the enhancement run on the card unless
``--train-platform`` / ``--platform`` say ``cpu``. Where the builders
wrote the ``--std-norm`` statistics as ``.npz`` (a machine without
``h5py``), the steps are given those files. Writes one JSON with the JAX
script's keys and prints markdown tables.
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[2]


def run(module: str, argv) -> str:
    """``python -m dvae_tpu_torch.cli.<module> argv`` in this directory,
    with the package importable; raises with the tail of its output when
    it fails."""
    cmd = [sys.executable, "-m", f"dvae_tpu_torch.cli.{module}", *map(str, argv)]
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(PACKAGE_ROOT),
                                                    env.get("PYTHONPATH")) if p)
    r = subprocess.run(cmd, text=True, capture_output=True, env=env)
    if r.returncode != 0:
        raise RuntimeError(f"{module} failed rc={r.returncode}:\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return r.stdout


def f1_prec_rec(pred, ref):
    """(F1, precision, recall) of hard frame labels through the one F1 of
    the package (``f1_loss``), so the study's numbers compare with
    ``predict_vad_labels`` and ``run_metrics_classif``."""
    import torch

    from dvae_tpu_torch.models.losses import f1_loss

    _, prec, rec, f1 = f1_loss(torch.as_tensor(np.asarray(pred, np.float32)),
                               torch.as_tensor(np.asarray(ref, np.float32)))
    return float(f1), float(prec), float(rec)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dvae_tpu_torch.cli.av_fusion_study",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-root", required=True,
                    help="parent of subset/ (lip videos and the noisy tree built)")
    ap.add_argument("--models-root", required=True)
    ap.add_argument("--out", default="evidence/av_fusion_matrix.json")
    ap.add_argument("--train", action="store_true",
                    help="train the three VADs first (matched budgets)")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--emb-dim", type=int, default=32)
    ap.add_argument("--num-layers", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-split", default=None,
                    help="catalog split the VAD trainers train on; 'test' = the "
                         "label-producer regime (the nets train on the sweep speaker's own "
                         "utterances)")
    ap.add_argument("--valid-split", default=None)
    ap.add_argument("--run-tag", default="",
                    help="suffix of the model-dir, prediction and output names, so a "
                         "second protocol never overwrites the first's")
    ap.add_argument("--enhance-model-dir", default=None,
                    help="an M2 (VAD) model dir: run the conditioned-enhancement legs "
                         "(oracle + 3 modalities)")
    ap.add_argument("--niter", type=int, default=100)
    ap.add_argument("--snr", default="-5")
    ap.add_argument("--platform", choices=("cpu", "cuda"), default=None,
                    help="device of the predict and enhance legs; default: the CUDA card")
    ap.add_argument("--train-platform", choices=("cpu", "cuda"), default=None,
                    help="device of the trainers; default: the CUDA card")
    return ap.parse_args(argv)


def _platform(flag):
    return [] if flag is None else ["--platform", flag]


def _stats(proc: pathlib.Path) -> tuple[list, list]:
    """``--stats-h5`` / ``--video-stats-h5`` for the steps' ``--std-norm``:
    the builders' statistics files where they exist under either suffix
    (the ``.h5`` first), else nothing (the steps' own defaults)."""
    from dvae_tpu_torch.data.builders import NOISY_STATS, VIDEO_STATS
    from dvae_tpu_torch.data.io import array_file

    audio, video = (array_file(proc / f"{rel}.h5") for rel in (NOISY_STATS, VIDEO_STATS))
    return ([] if audio is None else ["--stats-h5", audio],
            [] if video is None else ["--video-stats-h5", video])


def main(argv=None) -> dict:
    args = parse_args(argv)
    from dvae_tpu_torch.data.catalog.ntcd_timit import _grids
    from dvae_tpu_torch.data.io import array_file, read_labels

    data_root = pathlib.Path(args.data_root)
    models_root = pathlib.Path(args.models_root)
    processed = data_root / "subset" / "processed"
    proc = processed / "ntcd_timit"
    noisy_root = proc / "Noisy"
    # the catalog's subset grid, not the filesystem's: the predict and
    # evaluate CLIs walk the catalog
    noise_types, snrs = _grids("subset")
    if str(args.snr) not in snrs:
        raise SystemExit(
            f"--snr {args.snr} is not in the catalog's subset grid {snrs}: "
            "the predict/enhance legs would write conditions the F1 sweep "
            "never reads (fail now, before the expensive training legs)")
    conditions = sorted((t, s) for t in noise_types for s in snrs
                        if s == str(args.snr) and (noisy_root / t / s).is_dir())
    common = ["--dataset-size", "subset", "--data-root", data_root,
              "--models-root", models_root]
    audio_stats, video_stats = _stats(processed)

    tag = f"_{args.run_tag}" if args.run_tag else ""
    results = {"protocol": {
        "budgets": {"epochs": args.epochs, "hidden": args.hidden,
                    "emb_dim": args.emb_dim, "num_layers": args.num_layers,
                    "seed": args.seed},
        "splits": {"train": args.train_split or "train",
                   "valid": args.valid_split or "validation"},
        "conditions": [f"{t}/{s}" for t, s in conditions],
        "date": time.strftime("%Y-%m-%d"),
    }, "training": {}, "f1_per_condition": {}, "enhancement": {}}
    hl = f"{args.hidden}x{args.num_layers}"
    names = {"audio": f"ntcd_audio_vad_lstm_{hl}_norm{tag}",
             "video": f"ntcd_video_vad_{hl}_norm{tag}",
             "av": f"ntcd_av_vad_{hl}_norm{tag}"}

    # ---- 1. matched-budget training
    shape = ["--hidden", args.hidden, "--num-layers", args.num_layers,
             "--end-epoch", args.epochs, "--seed", args.seed, "--std-norm",
             *_platform(args.train_platform)]
    for flag, v in (("--train-split", args.train_split), ("--valid-split", args.valid_split)):
        if v:
            shape += [flag, v]
    if args.train:
        t0 = time.time()
        run("train_audio_net", [*common, *shape, *audio_stats, "--run-name", names["audio"]])
        results["training"]["audio_s"] = round(time.time() - t0, 1)
        for modality in ("video", "av"):
            t0 = time.time()
            run("train_video_net", [*common, *shape, *video_stats,
                                    *(audio_stats if modality == "av" else []),
                                    "--modality", modality, "--emb-dim", args.emb_dim,
                                    "--run-name", names[modality]])
            results["training"][f"{modality}_s"] = round(time.time() - t0, 1)

    def latest(pattern):
        hits = sorted(glob.glob(str(models_root / pattern)))
        if not hits:
            raise FileNotFoundError(f"no model dir matches {pattern} (run with --train first)")
        return hits[-1]

    if args.run_tag:
        dirs = {m: str(models_root / names[m]) for m in names}
        for d in dirs.values():
            if not os.path.isdir(d):
                raise FileNotFoundError(f"{d} missing (run with --train)")
    else:
        # the exact shape of the flags (hidden x layers), and a trailing
        # 'norm' that keeps run-tagged dirs out
        dirs = {"audio": latest(f"ntcd_audio_vad_lstm_{hl}*norm"),
                "video": latest(f"ntcd_video_vad_{hl}*norm"),
                "av": latest(f"ntcd_av_vad_{hl}*norm")}
    results["checkpoints"] = {k: os.path.basename(v) for k, v in dirs.items()}

    # what the model dirs trained, from their checkpoints, never --epochs
    for modality, mdir in dirs.items():
        rows = []
        for j in sorted(glob.glob(os.path.join(mdir, "*_epoch_*.json"))):
            with open(j) as fh:
                rows.append(json.load(fh))
        if not rows:
            continue
        best = min(rows, key=lambda m: m["valid_bce"])
        results["training"][modality] = {
            "epochs_trained": len(rows),
            "best_vloss_epoch": best["epoch"],
            "best_valid_bce": round(best["valid_bce"], 4),
            "best_checkpoint_valid_f1": round(best["valid_f1"], 4),
            "final_epoch_valid_f1": round(rows[-1]["valid_f1"], 4),
            "max_valid_f1_any_epoch": round(max(m["valid_f1"] for m in rows), 4),
        }
    trained = {v["epochs_trained"] + 1 for v in results["training"].values()
               if isinstance(v, dict) and "epochs_trained" in v}
    if len(trained) == 1:
        results["protocol"]["budgets"]["epochs"] = trained.pop()
    elif trained:
        # the modalities trained different counts (a resumed or longer run
        # in one dir): record the disagreement, not one headline budget
        results["protocol"]["budgets"]["epochs"] = None
        results["protocol"]["budgets"]["epochs_mismatch"] = {
            m: v["epochs_trained"] + 1 for m, v in results["training"].items()
            if isinstance(v, dict) and "epochs_trained" in v}
        print("WARNING: modalities trained different epoch counts "
              f"({results['protocol']['budgets']['epochs_mismatch']}); budgets.epochs "
              "recorded as null — this is NOT a matched-budget run", flush=True)
    results["protocol"]["budgets"]["epochs_arg"] = args.epochs

    # ---- 2. predictions per modality
    preds_root = models_root / f"av_study_preds{tag}"
    for modality, mdir in dirs.items():
        argv_m = [*common, "--modality", modality, "--model-dir", mdir,
                  "--hidden", args.hidden, "--num-layers", args.num_layers, "--std-norm",
                  "--output-dir", preds_root / modality, "--overwrite", "--snr", args.snr,
                  *(video_stats if modality != "audio" else []),
                  *(audio_stats if modality != "video" else []), *_platform(args.platform)]
        if modality != "audio":
            argv_m += ["--emb-dim", args.emb_dim]
        run("predict_vad_labels", argv_m)

    # ---- 3. F1 per condition
    @functools.lru_cache(maxsize=None)
    def oracle_vad(spk_dir, utt):
        # cached: read once for the modality x condition loop
        path = array_file(proc / "Clean" / "test" / spk_dir / f"{utt}_vad_labels_upsampled.h5")
        return (read_labels(path).reshape(-1) > 0.5).astype(np.int32)

    test_utts = [(spk.name, wav.stem) for spk in sorted((proc / "Clean" / "test").iterdir())
                 if spk.is_dir() for wav in sorted(spk.glob("*.wav"))]
    table = {}
    for modality in dirs:
        per_cond = {}
        for ntype, snr in conditions:
            preds, refs = [], []
            for spk, utt in test_utts:
                if modality == "video":
                    p = (preds_root / modality / "ntcd_timit" / "Clean" / "test" / spk /
                         f"{utt}_y_hat_hard.npy")
                else:
                    p = (preds_root / modality / "ntcd_timit" / "Noisy" / ntype / snr /
                         "test" / spk / f"{utt}_y_hat_hard.npy")
                yh = np.load(p).reshape(-1)
                yr = oracle_vad(spk, utt)
                n = min(len(yh), len(yr))
                preds.append((yh[:n] > 0.5).astype(np.int32))
                refs.append(yr[:n])
            f1, prec, rec = f1_prec_rec(np.concatenate(preds), np.concatenate(refs))
            per_cond[f"{ntype}/{snr}"] = {"f1": round(f1, 4), "precision": round(prec, 4),
                                          "recall": round(rec, 4)}
        per_cond["overall_mean_f1"] = round(float(np.mean([v["f1"] for v in
                                                           per_cond.values()])), 4)
        table[modality] = per_cond
    results["f1_per_condition"] = table

    print("\n| condition | " + " | ".join(f"{m} F1" for m in table) + " |")
    print("|---|" + "---|" * len(table))
    for ntype, snr in conditions:
        c = f"{ntype}/{snr}"
        print(f"| {c} | " + " | ".join(f"{table[m][c]['f1']:.3f}" for m in table) + " |")
    print("| mean | " + " | ".join(f"{table[m]['overall_mean_f1']:.3f}" for m in table) + " |")

    # ---- 4. conditioned-enhancement legs
    if args.enhance_model_dir:
        legs = {"oracle": None, **{m: preds_root / m for m in dirs}}
        for leg, cdir in legs.items():
            out_dir = models_root / f"av_study_enhanced{tag}" / leg
            argv_e = [*common, "--labels", "vad_labels", "--model-dir", args.enhance_model_dir,
                      "--niter", args.niter, "--snr", args.snr, "--output-dir", out_dir,
                      *_platform(args.platform)]
            argv_e += (["--y-source", "oracle"] if leg == "oracle" else
                       ["--y-source", "classifier", "--classifier-dir", cdir])
            t0 = time.time()
            run("evaluate_ntcd_m2", argv_e)
            # the enhancement process alone, stamped before the host-side scoring
            wall = round(time.time() - t0, 1)
            results["enhancement"][leg] = score_tree(out_dir, proc,
                                                     "" if leg == "oracle" else "_y_hat_hard")
            results["enhancement"][leg]["wall_s"] = wall
        base = results["enhancement"]["oracle"]
        for leg in dirs:
            r = results["enhancement"][leg]
            r["delta_vs_oracle"] = {"si_sdr": round(r["si_sdr"] - base["si_sdr"], 3),
                                    "estoi": round(r["estoi"] - base["estoi"], 4),
                                    "pesq": round(r["pesq"] - base["pesq"], 3)}
        print("\n| conditioning | SI-SDR | ESTOI | nPESQ | Δ SI-SDR vs oracle |")
        print("|---|---|---|---|---|")
        for leg, r in results["enhancement"].items():
            d = r.get("delta_vs_oracle", {}).get("si_sdr")
            print(f"| {leg} | {r['si_sdr']:+.2f} | {r['estoi']:.3f} | {r['pesq']:.2f} | "
                  f"{'' if d is None else f'{d:+.2f} dB'} |")

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"\nwrote {out}")
    return results


def score_tree(out_dir, proc, suffix: str) -> dict:
    """Mean SI-SDR (LeRoux), ESTOI and native wideband PESQ of every
    ``*_s_est<suffix>.wav`` under ``out_dir`` against its clean utterance,
    50 ms trimmed at each end."""
    from dvae_tpu_torch.data.io import read_wav
    from dvae_tpu_torch.eval.pesq_native import pesq_wb
    from dvae_tpu_torch.eval.si_sdr import si_sdr_leroux
    from dvae_tpu_torch.eval.stoi import stoi

    fs = 16000
    trim = int(0.05 * fs)
    rows = []
    for est in pathlib.Path(out_dir).rglob(f"*_s_est{suffix}.wav"):
        utt = est.name[:-len(f"_s_est{suffix}.wav")]
        s, _ = read_wav(pathlib.Path(proc) / "Clean" / "test" / est.parent.name / f"{utt}.wav")
        e, _ = read_wav(est)
        a, b = trim, min(len(s), len(e)) - trim
        rows.append((float(si_sdr_leroux(e[a:b], s[a:b])),
                     float(stoi(s[a:b], e[a:b], fs, extended=True)),
                     float(pesq_wb(s[a:b], e[a:b], fs))))
    if not rows:
        raise RuntimeError(f"no *_s_est{suffix}.wav under {out_dir}")
    m = np.asarray(rows).mean(axis=0)
    return {"n": len(rows), "si_sdr": round(float(m[0]), 3), "estoi": round(float(m[1]), 4),
            "pesq": round(float(m[2]), 3)}


if __name__ == "__main__":
    main()
