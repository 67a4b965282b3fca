"""What the three NTCD-TIMIT evaluation CLIs share: their flags, the
``Enhancer`` they build from a ``.pt`` checkpoint, the label sources of the
conditional families, and the sweep itself
(:func:`~dvae_tpu_torch.enhance.evaluate.evaluate_sweep`)."""

from __future__ import annotations

import argparse
import os

from dvae_tpu_torch.cli._family import (
    ablation_of,
    add_ablation,
    add_common,
    add_mcem_budgets,
    add_shard,
    add_std_norm_eval,
    default_out_dir,
    load_family_model,
    mcem_config_of,
    norm_stats_if,
    processed_dir,
    shard_of,
)
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.enhance.evaluate import (
    evaluate_sweep,
    find_classifier_labels,
    load_oracle_labels,
)
from dvae_tpu_torch.enhance.labeling import constant_labels
from dvae_tpu_torch.enhance.pipeline import _LATER, Enhancer, EnhancerConfig


def sweep_parser(prog: str, doc: str) -> argparse.ArgumentParser:
    """The flags every sweep CLI takes."""
    ap = add_common(argparse.ArgumentParser(
        prog=prog, description=doc, formatter_class=argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--checkpoint", default=None,
                    help="a .pt state_dict; defaults to the best in --model-dir")
    ap.add_argument("--model-dir", default=None)
    ap.add_argument("--z-dim", type=int, default=16)
    ap.add_argument("--h-dim", type=int, nargs="+", default=[128, 128])
    add_mcem_budgets(ap)
    ap.add_argument("--snr", default="10", help="SNR filter ('all' = every SNR)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard each utterance batch over all visible devices "
                         "(not served yet)")
    ap.add_argument("--output-dir", default=None)
    add_ablation(ap)
    add_std_norm_eval(ap)
    add_shard(ap)
    return ap


def parse_sweep_args(ap: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse, then refuse what cannot run, before any model or data is
    loaded."""
    args = ap.parse_args(argv)
    if not (args.checkpoint or args.model_dir):
        ap.error("need --checkpoint or --model-dir")
    if args.data_parallel:
        ap.error("--data-parallel: " + _LATER.format(14))
    shard_of(args)
    return args


def build_enhancer(args, model_class: str, y_dim: int = 1, y_mode: str = "none",
                   mcem=None):
    """``(enhancer, out_dir, norm)`` for the sweep: the device (the card
    unless ``--platform cpu``), the ``--std-norm`` statistics, the family's
    model from its checkpoint, and the engine, budgets and ablation of the
    flags (``mcem`` replaces the budgets)."""
    device = resolve_device(args.platform)
    norm = norm_stats_if(args)
    args.model_class, args.y_dim = model_class, y_dim
    model, path = load_family_model(args)
    print(f"loaded {path}")
    cfg = EnhancerConfig(mcem=mcem or mcem_config_of(args), y_mode=y_mode,
                         ablation=ablation_of(args), norm=norm, engine=args.engine)
    return Enhancer(model, cfg, device=device), default_out_dir(args, path), norm


def add_label_source(ap: argparse.ArgumentParser, choices, help_extra: str = "") -> None:
    ap.add_argument("--y-source", default="oracle", choices=choices,
                    help="labels of the conditional model: oracle = the label h5s "
                         "(needs h5py), classifier = precomputed *_y_hat_hard.pt/.npy "
                         "under --classifier-dir, ones/zeros = constant-label "
                         "ablations (their frame count comes from the oracle h5, so "
                         "they need h5py too)" + help_extra)
    ap.add_argument("--classifier-dir", default=None,
                    help="dir with *_y_hat_hard.pt/.npy for --y-source classifier")


def label_loader(args, y_dim: int, self_soft=None):
    """``(noisy_rel, clean_rel) -> (n_frames, y_dim)`` labels of
    ``--y-source``; ``self_soft(clean_rel)`` serves ``self-soft``."""
    proc = processed_dir(args)

    def y_loader(noisy_rel, clean_rel):
        if args.y_source == "oracle":
            return load_oracle_labels(os.path.join(proc, clean_rel))
        if args.y_source == "classifier":
            utt = os.path.splitext(os.path.basename(noisy_rel))[0]
            # prefer labels predicted from this noise/SNR condition's mixture
            return find_classifier_labels(args.classifier_dir, noisy_rel.split("/")[-2], utt,
                                          y_dim, rel_dir=os.path.dirname(noisy_rel))
        if args.y_source == "self-soft":
            return self_soft(clean_rel)
        n = load_oracle_labels(os.path.join(proc, clean_rel)).shape[0]
        return constant_labels(n, y_dim, args.y_source)

    return y_loader


def run_sweep(args, enh, out_dir, y_loader=None, suffix: str = "") -> int:
    n = evaluate_sweep(
        enh, processed_dir(args), out_dir, dataset_size=args.dataset_size,
        labels=args.labels, snr_filter=None if args.snr == "all" else args.snr,
        batch_size=args.batch_size, shard=shard_of(args), y_loader=y_loader, suffix=suffix)
    print(f"done: {n} utterances -> {out_dir}")
    return n
