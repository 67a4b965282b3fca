"""What the six reconstruct CLIs share (the port's counterparts of the JAX
package's ``scripts/reconstruct_*.py``): their flags, the trained model on
the device, and the two utterance walks (the NTCD noisy/clean pairs of the
catalog, and the QUT ``_s/_n/_x.wav`` triplets that ``create_test_set``
writes). Every CLI draws figures, so each needs ``matplotlib``, checked
before any device work."""

from __future__ import annotations

import argparse
import glob
import os

from dvae_tpu_torch import viz
from dvae_tpu_torch.cli._family import add_common, load_family_model, processed_dir
from dvae_tpu_torch.data.catalog import ntcd_timit
from dvae_tpu_torch.device import resolve_device


def parser(prog: str, doc: str, output_dir: str, ntcd: bool) -> argparse.ArgumentParser:
    """The flags of a reconstruct CLI; ``ntcd`` adds ``--snr``."""
    ap = add_common(argparse.ArgumentParser(
        prog=prog, description=doc, formatter_class=argparse.RawDescriptionHelpFormatter))
    ap.add_argument("--checkpoint", default=None, help="a .pt state_dict")
    ap.add_argument("--model-dir", default=None,
                    help="training output dir (the .pt with the lowest vloss is used)")
    ap.add_argument("--z-dim", type=int, default=16)
    ap.add_argument("--h-dim", type=int, nargs="+", default=[128, 128])
    if ntcd:
        ap.add_argument("--snr", default=None)
    ap.add_argument("--output-dir", default=output_dir)
    ap.add_argument("--max-utts", type=int, default=10)
    return ap


def checked(ap: argparse.ArgumentParser, args) -> argparse.Namespace:
    """Refuse what cannot run, before any model or data is loaded: a
    missing checkpoint flag, and a machine without ``matplotlib``."""
    if not (args.checkpoint or args.model_dir):
        ap.error("need --checkpoint or --model-dir")
    viz.require_matplotlib("the reconstruction figures")
    return args


def load_model(args, model_class: str, y_dim: int = 1):
    """``(model, device)``: the family's model with its checkpoint
    strict-loaded, on the card unless ``--platform cpu``."""
    device = resolve_device(args.platform)
    args.model_class, args.y_dim = model_class, y_dim
    model, path = load_family_model(args)
    print(f"loaded {path}")
    return model.to(device).eval(), device


def ntcd_items(args, labels: str) -> list:
    """The catalog's (noisy rel, clean label rel) test pairs, ``--snr``
    filtered, the first ``--max-utts``."""
    proc = processed_dir(args)
    items = list(ntcd_timit.proc_noisy_clean_pair_dict(
        proc + "/", "test", args.dataset_size, labels, upsampled=True).items())
    if args.snr:
        items = [it for it in items if it[0].split("/")[-4] == args.snr]
    return items[: args.max_utts]


def ntcd_name(noisy_rel: str) -> str:
    """``<noise>_<snr>_<utt>``: a pair's figure name stem."""
    parts = noisy_rel.split("/")
    return f"{parts[-5]}_{parts[-4]}_{os.path.splitext(os.path.basename(noisy_rel))[0]}"


def qut_mixtures(args) -> list[str]:
    """The first ``--max-utts`` QUT mixtures ``*_x.wav``, sorted; exits
    when there are none."""
    qut_dir = os.path.join(processed_dir(args), "ntcd_timit/qutnoise_databases")
    mixtures = sorted(glob.glob(qut_dir + "/**/*_x.wav", recursive=True))[: args.max_utts]
    if not mixtures:
        raise SystemExit(f"no QUT mixtures under {qut_dir}; run "
                         "python -m dvae_tpu_torch.cli.create_test_set first")
    return mixtures
