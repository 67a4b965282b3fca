"""Enhance arbitrary wav files with a trained model of any family, on the
card (port of the JAX package's ``scripts/enhance_wav.py``).

    python -m dvae_tpu_torch.cli.enhance_wav noisy1.wav recordings/ \\
        --model-dir models/ntcd_M1_... --output-dir enhanced/

Runs the batched ``Enhancer`` (``--engine``: MCEM or one of its variants)
over any list of wav files or directories (searched recursively). Conditional models need no oracle
labels: ``--y-source self-soft`` runs the model's own x->y classifier on
the noisy mixture (v3/v4/v5); ``npy`` reads a ``<stem>_y.npy`` beside each
input; ``ones`` / ``zeros`` are the constant-label ablations. Outputs are
``<stem>_s_est.wav`` / ``<stem>_n_est.wav`` (the Wiener split: s_est +
n_est reconstructs the input), in one flat directory. ``--chunk-seconds``
enhances one file at a time in cross-faded chunks, ``--chunk-concurrency``
chunks per dispatch, so device memory does not grow with the file's
length (``enhance/longform.py``). ``--platform cpu``
runs the plain PyTorch path on the CPU; the default is the CUDA card."""

from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np

from dvae_tpu_torch.cli._family import (
    add_mcem_budgets,
    add_model_family,
    load_family_model,
    mcem_config_of,
    read_norm_stats,
    warn_peem_family,
)
from dvae_tpu_torch.data.io import read_wav, resample, wav_sample_rate, write_wav
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.enhance.labeling import classify_method_of, constant_labels, self_soft_labels
from dvae_tpu_torch.enhance.longform import chunk_spans, enhance_chunked
from dvae_tpu_torch.enhance.mcem import fold_seed
from dvae_tpu_torch.enhance.pipeline import _LATER, Enhancer, EnhancerConfig
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped


def gather_inputs(paths) -> list[pathlib.Path]:
    out = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            out.extend(sorted(q for q in p.rglob("*.wav")
                              if not q.name.endswith(("_s_est.wav", "_n_est.wav"))))
        elif p.suffix.lower() == ".wav":
            out.append(p)
        else:
            raise SystemExit(f"{p}: not a wav file or directory")
    if not out:
        raise SystemExit("no input wav files found")
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m dvae_tpu_torch.cli.enhance_wav", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("inputs", nargs="+",
                    help="wav files and/or directories (searched recursively for *.wav)")
    add_model_family(ap)
    add_mcem_budgets(ap)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard each batch over all visible devices (not served yet)")
    ap.add_argument("--y-source", default="self-soft",
                    choices=["self-soft", "npy", "ones", "zeros"],
                    help="labels for conditional classes (ignored for m1): "
                         "self-soft = the model's own classifier on the mixture "
                         "(v3/v4/v5 only); npy = <stem>_y.npy next to each input")
    ap.add_argument("--std-norm", action="store_true",
                    help="the model was trained with --std-norm; requires --norm-h5")
    ap.add_argument("--norm-h5", default=None,
                    help="h5 with X_train_mean/X_train_std for --std-norm (needs h5py)")
    ap.add_argument("--output-dir", default="enhanced",
                    help="where <stem>_s_est.wav/_n_est.wav land (flat; name "
                         "collisions across input dirs get _2, _3, ...)")
    ap.add_argument("--resample", action="store_true",
                    help="polyphase-resample inputs whose rate differs from the "
                         "model's 16 kHz (outputs stay at 16 kHz); without it a "
                         "mismatched file is an error")
    ap.add_argument("--chunk-seconds", type=float, default=None,
                    help="bounded-memory mode for very long recordings: split each file "
                         "into chunks of this many seconds and cross-fade the overlaps; "
                         "device memory stops growing with file length "
                         "(enhance/longform.py)")
    ap.add_argument("--chunk-overlap", type=float, default=1.0,
                    help="cross-fade overlap in seconds for --chunk-seconds (at most half "
                         "a chunk)")
    ap.add_argument("--chunk-concurrency", type=int, default=4,
                    help="chunks per device dispatch, the memory bound: resident state is "
                         "chunk-concurrency x chunk-seconds of audio, whatever the file "
                         "length")
    ap.add_argument("--overwrite", action="store_true",
                    help="re-enhance files whose outputs already exist "
                         "(default: resume-by-skip)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", choices=("cpu", "cuda"), default=None,
                    help="cpu runs the plain PyTorch path; default: the CUDA card")
    args = ap.parse_args(argv)
    if not (args.checkpoint or args.model_dir):
        ap.error("need --checkpoint or --model-dir")
    if args.std_norm and not args.norm_h5:
        ap.error("--std-norm requires --norm-h5 (this CLI has no corpus tree to "
                 "locate the training statistics in)")
    if args.y_source == "self-soft" and args.model_class in ("m2", "m2v2"):
        ap.error(f"{args.model_class} has no classifier; use --y-source npy/ones/zeros")
    if args.data_parallel:
        ap.error("--data-parallel: " + _LATER.format(14))
    if args.chunk_seconds:
        if args.chunk_concurrency < 1:
            ap.error("--chunk-concurrency must be >= 1")
        try:
            chunk_spans(1, StftConfig().fs, StftConfig().hop, args.chunk_seconds,
                        args.chunk_overlap)
        except ValueError as e:
            ap.error(f"--chunk-overlap: {e}")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.platform)
    conditional = args.model_class != "m1"
    norm = read_norm_stats(args.norm_h5) if args.std_norm else None
    stft_cfg = StftConfig()
    files = gather_inputs(args.inputs)

    # fail fast before any decode or device work: a rate mismatch or a
    # missing label file in the last batch must not abort a long run halfway
    for p in files:
        fs_in = wav_sample_rate(p)
        if fs_in != stft_cfg.fs and not args.resample:
            raise SystemExit(f"{p}: {fs_in} Hz != model rate {stft_cfg.fs} Hz "
                             "(pass --resample to convert)")
        side = p.with_name(p.stem + "_y.npy")
        if conditional and args.y_source == "npy" and not side.exists():
            raise SystemExit(f"--y-source npy: {side} not found")

    model, path = load_family_model(args)
    print(f"loaded {path}")
    warn_peem_family(args, args.model_class, args.y_dim)
    y_mode = {"m1": "none", "m2": "enc_dec"}.get(args.model_class, "dec_only")
    enh = Enhancer(model, EnhancerConfig(mcem=mcem_config_of(args), y_mode=y_mode, norm=norm,
                                         engine=args.engine), device=device)
    classify_method = classify_method_of(args.model_class)

    def load_input(p):
        x, fs = read_wav(p)
        if x.ndim > 1:
            x = x.mean(axis=-1)  # downmix multi-channel
        return resample(x, fs, stft_cfg.fs).astype(np.float32)

    def labels_for(p, x):
        """Per-file labels of the constant and npy sources (self-soft
        labels come per batch, in one classifier call)."""
        n = n_stft_frames_clamped(len(x), stft_cfg)
        if args.y_source in ("ones", "zeros"):
            return constant_labels(n, args.y_dim, args.y_source)
        side = p.with_name(p.stem + "_y.npy")
        y = np.load(side).astype(np.float32).reshape(-1, args.y_dim)
        if len(y) < n:
            raise SystemExit(f"{side}: {len(y)} labels < {n} frames")
        return y[:n]

    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # flat output names; duplicate stems from different dirs get suffixes,
    # assigned in input order so that they stay the same on a resumed run
    names, used = [], set()
    for p in files:
        stem, k = p.stem, 2
        while stem in used:
            stem, k = f"{p.stem}_{k}", k + 1
        used.add(stem)
        names.append(stem)

    todo = [i for i in range(len(files))
            if args.overwrite
            or not ((out_dir / f"{names[i]}_s_est.wav").exists()
                    and (out_dir / f"{names[i]}_n_est.wav").exists())]
    order = sorted(todo, key=lambda i: (os.path.getsize(files[i]), str(files[i])))

    def self_soft(wavs):
        return self_soft_labels(enh.model, wavs, stft_cfg, args.y_dim, classify_method,
                                norm=norm, norm_eps=enh.cfg.norm_eps)

    n_done = 0
    if args.chunk_seconds:
        # bounded-memory mode: one file at a time, its chunks are the device
        # batches (chunk-concurrency per dispatch)
        for j, i in enumerate(order):
            x = load_input(files[i])
            y_full, labeler = None, None
            if conditional:
                if args.y_source == "self-soft":
                    labeler = self_soft
                else:
                    y_full = labels_for(files[i], x)
            s_hat, n_hat = enhance_chunked(
                enh, x, y=y_full, labeler=labeler, chunk_seconds=args.chunk_seconds,
                overlap_seconds=args.chunk_overlap,
                max_concurrent_chunks=args.chunk_concurrency, seed=fold_seed(args.seed, j))
            write_wav(out_dir / f"{names[i]}_n_est.wav", n_hat, stft_cfg.fs)
            write_wav(out_dir / f"{names[i]}_s_est.wav", s_hat, stft_cfg.fs)
            n_done += 1
            print(f"enhanced {n_done}/{len(order)}")
    # otherwise batches of similar length: sorted by file size
    chunks = [] if args.chunk_seconds else [order[s:s + args.batch_size]
                                            for s in range(0, len(order), args.batch_size)]

    def batches():
        for chunk in chunks:
            wavs = [load_input(files[i]) for i in chunk]
            ys = None
            if conditional:
                if args.y_source == "self-soft":
                    ys = self_soft(wavs)
                else:
                    ys = [labels_for(files[i], w) for i, w in zip(chunk, wavs)]
            yield wavs, ys, None

    for chunk, out in zip(chunks, enh.enhance_stream(batches(), seed=args.seed)):
        for i, (s_hat, n_hat) in zip(chunk, out):
            write_wav(out_dir / f"{names[i]}_n_est.wav", n_hat, stft_cfg.fs)
            write_wav(out_dir / f"{names[i]}_s_est.wav", s_hat, stft_cfg.fs)
            n_done += 1
        print(f"enhanced {n_done}/{len(order)}")
    if len(order) < len(files):
        print(f"skipped {len(files) - len(order)} already-enhanced files "
              "(--overwrite redoes them)")
    print(f"done: {n_done} files -> {out_dir}")


if __name__ == "__main__":
    main()
