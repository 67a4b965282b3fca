"""Flags and loaders shared by the port's CLIs: the model family of a
checkpoint, the corpus tree, the E-step engine and its budgets, the
ablations and shards of an evaluation sweep (the port's copy of the parts
of the JAX package's ``scripts/_lib.py`` that these CLIs need).

Checkpoints are ``.pt`` state_dicts in the reference's names: a
reference checkpoint, one the port's trainers wrote, or a JAX ``.msgpack``
converted once on a CPU host with ``scripts/export_torch_checkpoint.py``.
HDF5 (label files, training statistics) is read with ``h5py``, imported
where a file is opened: a machine without it runs every path that reads
no HDF5.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import warnings

from dvae_tpu_torch.enhance.mcem import McemConfig
from dvae_tpu_torch.enhance.pipeline import ENGINES
from dvae_tpu_torch.models import CVAE, CVAE_v2, CVAE_v3, CVAE_v4, VAE, DisentangledVAE
from dvae_tpu_torch.train import checkpoint as ckpt

FAMILIES = {"m1": VAE, "m2": CVAE, "m2v2": CVAE_v2, "v3": CVAE_v3, "v4": CVAE_v4,
            "v5": DisentangledVAE}


def add_common(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The corpus tree and the device: ``<data-root>/<dataset-size>/`` holds
    ``processed/``; outputs default under ``--models-root``."""
    ap.add_argument("--dataset-size", default="subset", choices=["subset", "complete"])
    ap.add_argument("--labels", default="vad_labels", choices=["vad_labels", "ibm_labels"])
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--models-root", default="models")
    ap.add_argument("--platform", choices=("cpu", "cuda"), default=None,
                    help="cpu runs the plain PyTorch path; default: the CUDA card")
    return ap


def y_dim_for(labels: str) -> int:
    return 1 if labels == "vad_labels" else 513


def processed_dir(args) -> str:
    return os.path.join(args.data_root, args.dataset_size, "processed")


def frame_h5_path(args) -> str:
    return os.path.join(args.data_root, args.dataset_size, "processed", "ntcd_timit",
                        f"Clean_{args.labels}_upsampled.h5")


def add_model_family(ap: argparse.ArgumentParser) -> None:
    """Flags describing a trained model of any family."""
    ap.add_argument("--checkpoint", default=None, help="a .pt state_dict")
    ap.add_argument("--model-dir", default=None,
                    help="training output dir (the .pt with the lowest vloss is used)")
    ap.add_argument("--model-class", default="m1", choices=list(FAMILIES),
                    help="m1 = unconditional VAE; m2/m2v2 = label-conditioned "
                         "CVAEs; v3/v4/v5 = the M2-info families (own x->y "
                         "classifier, so self-soft labels need no label input)")
    ap.add_argument("--y-dim", type=int, default=1,
                    help="label width for conditional classes (1=VAD, 513=IBM)")
    ap.add_argument("--z-dim", type=int, default=16)
    ap.add_argument("--h-dim", type=int, nargs="+", default=[128, 128])


def family_model_template(args):
    """The port model of the ``add_model_family`` flags, freshly initialized."""
    cls = FAMILIES[args.model_class]
    if args.model_class == "m1":
        return cls(x_dim=513, z_dim=args.z_dim, h_dim=tuple(args.h_dim))
    return cls(x_dim=513, y_dim=args.y_dim, z_dim=args.z_dim, h_dim=tuple(args.h_dim))


def load_family_model(args):
    """(model, checkpoint_path): the family's model with the checkpoint
    strict-loaded (on the CPU; the ``Enhancer`` moves it)."""
    model = family_model_template(args)
    path = pathlib.Path(args.checkpoint) if args.checkpoint else \
        ckpt.best_checkpoint(args.model_dir)
    if path.suffix != ".pt":
        raise SystemExit(f"{path}: the port loads .pt state_dicts; convert a .msgpack "
                         "checkpoint once on a CPU host with "
                         "scripts/export_torch_checkpoint.py")
    ckpt.load_checkpoint(path, model)
    return model, path


def add_mcem_budgets(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The MCEM sampling budgets (None = the ``McemConfig`` default), the
    E-step engine and its own budgets."""
    ap.add_argument("--niter", type=int, default=100,
                    help="EM iterations (reference production 100)")
    ap.add_argument("--nmf-rank", type=int, default=10)
    ap.add_argument("--nsamples-e-step", type=int, default=None,
                    help="MH samples per E-step (default 10)")
    ap.add_argument("--burnin-e-step", type=int, default=None,
                    help="MH burn-in per E-step (default 30)")
    ap.add_argument("--nsamples-wf", type=int, default=None,
                    help="MH samples for the Wiener expectation (default 25)")
    ap.add_argument("--burnin-wf", type=int, default=None,
                    help="MH burn-in for the Wiener expectation (default 75)")
    ap.add_argument("--var-rw", type=float, default=None,
                    help="MH random-walk proposal variance (default 0.01)")
    ap.add_argument("--engine", choices=list(ENGINES), default="mcem",
                    help="E-step inference: 'mcem' = the reference's "
                         "Metropolis-Hastings Monte-Carlo EM; 'peem' = "
                         "point-estimate EM (MAP latent by Adam steps, "
                         "deterministic masks, no chain); 'peem-wf' = PEEM's "
                         "iterations + MCEM's sampled Wiener expectation; "
                         "'pmcem' = parallel-chain MCEM (R chains advanced "
                         "together as the rows of one chain segment)")
    ap.add_argument("--peem-steps", type=int, default=None,
                    help="[--engine peem/peem-wf] Adam steps on the latent per "
                         "EM iteration (default 4)")
    ap.add_argument("--peem-lr", type=float, default=None,
                    help="[--engine peem/peem-wf] Adam learning rate (default 0.01)")
    ap.add_argument("--pmcem-chains", type=int, default=None,
                    help="[--engine pmcem] parallel MH chains (default 10)")
    ap.add_argument("--pmcem-steps", type=int, default=None,
                    help="[--engine pmcem] MH steps per EM iteration, all chains "
                         "together (default 4)")
    return ap


def mcem_config_of(args, **overrides) -> McemConfig:
    """``McemConfig`` from the ``add_mcem_budgets`` flags (None = the class
    default), then ``overrides``. Warns when PEEM runs fewer than 100 EM
    iterations: the JAX package measured PEEM's quality unstable at reduced
    EM budgets (the NMF noise model underfits)."""
    if getattr(args, "engine", "mcem") in ("peem", "peem-wf") and args.niter < 100:
        warnings.warn(
            f"--engine {args.engine} with --niter {args.niter} < 100: PEEM quality "
            "(and peem-wf's, which runs the same EM loop) was measured unstable at "
            "reduced EM budgets (per-utterance SI-SDR swings of +6/-3.5 dB at "
            "niter=20; the NMF noise model underfits). Keep --niter >= 100 under "
            "peem. Proceeding as requested.", stacklevel=2)
    kw = dict(niter=args.niter, nmf_rank=args.nmf_rank)
    for field in ("nsamples_e_step", "burnin_e_step", "nsamples_wf", "burnin_wf", "var_rw",
                  "peem_steps", "peem_lr", "pmcem_chains", "pmcem_steps"):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    kw.update(overrides)
    return McemConfig(**kw)


def warn_peem_family(args, model_class: str, y_dim: int = 1) -> None:
    """Warn when ``--engine peem/peem-wf/pmcem`` targets a family whose
    posterior is informative (v3, or m2/m2v2 conditioned on IBM labels,
    y_dim 513): the JAX package's engine-quality matrices measured these
    engines well below MCEM there (peem/peem-wf 2.7-5.0 dB, pmcem 3.9 dB
    SI-SDR at a matched sample budget). Run a paired MCEM check before
    trusting the speed-up. ``model_class``: m1/m2/m2v2/v3/v4/v5."""
    engine = getattr(args, "engine", "mcem")
    if engine not in ("peem", "peem-wf", "pmcem"):
        return
    if model_class == "v3" or (model_class in ("m2", "m2v2") and y_dim == 513):
        deficit = ("measured -3.9 dB SI-SDR below MCEM at a matched sample budget"
                   if engine == "pmcem" else "measured 2.7-5.0 dB below MCEM")
        warnings.warn(
            f"--engine {engine} on an "
            f"{'IBM-conditioned' if y_dim == 513 else model_class}-class model: the "
            f"engine-quality matrix {deficit} on this family class. Run a paired MCEM "
            "check on your checkpoint before relying on these outputs; MCEM is the "
            "quality-safe default.", stacklevel=2)


def add_ablation(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference's oracle-latent experiment modes."""
    ap.add_argument(
        "--ablation", default="none", choices=["none", "clean-z", "clean-z-nomcem"],
        help="oracle-latent ablations: 'clean-z' starts the MH chain from the "
             "CLEAN spectrogram's encoding instead of the mixture's; "
             "'clean-z-nomcem' pins the latent there and skips the Monte-Carlo "
             "machinery (EM fits only the NMF noise model; deterministic Wiener "
             "masks). Outputs carry the reference's golden prefix, e.g. "
             "sa1_clean_z_nomcem_s_est.wav")
    return ap


def ablation_of(args) -> str:
    return args.ablation.replace("-", "_")


def default_out_dir(args, ckpt_path) -> str:
    """Where a sweep writes: ``--output-dir``, else
    ``<models-root>/enhanced/<model dir name>/<checkpoint stem>/`` (never
    under ``--data-root``, which may be a read-only corpus; the model dir's
    name keeps models that share a checkpoint prefix apart)."""
    ckpt_path = str(ckpt_path)
    model_name = os.path.basename(os.path.normpath(
        args.model_dir or os.path.dirname(ckpt_path)))
    return args.output_dir or os.path.join(
        args.models_root, "enhanced", model_name,
        os.path.splitext(os.path.basename(ckpt_path))[0])


def add_std_norm_eval(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--std-norm", action="store_true",
                    help="the model was trained with --std-norm: normalize the "
                         "encoder input with the training h5's "
                         "X_train_mean/X_train_std (needs h5py)")
    ap.add_argument("--norm-h5", default=None,
                    help="frame h5 holding X_train_mean/X_train_std for "
                         "--std-norm; defaults to the frame h5 of this "
                         "command's --labels")


def read_norm_stats(path):
    """(X_train_mean, X_train_std) from an h5 file, read with h5py on a CPU
    host."""
    try:
        import h5py
    except ImportError:
        raise SystemExit("--std-norm needs h5py, which this machine lacks: reading "
                         "the HDF5 training statistics is a CPU-host path") from None
    with h5py.File(path, "r") as f:
        return f["X_train_mean"][:], f["X_train_std"][:]


def norm_stats_if(args):
    """(mean, std) from the training frame h5 when ``--std-norm``, else None."""
    if not getattr(args, "std_norm", False):
        return None
    return read_norm_stats(getattr(args, "norm_h5", None) or frame_h5_path(args))


def add_shard(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--shard", default=None, metavar="K/N",
                    help="enhance only the K-th of N contiguous chunks of the "
                         "utterance list (0-based): coordination-free fan-out "
                         "across machines into a shared output tree; combine "
                         "with resume-by-skip for restarts")


def shard_of(args) -> tuple[int, int] | None:
    s = getattr(args, "shard", None)
    if s is None:
        return None
    try:
        k, n = (int(p) for p in s.split("/"))
    except ValueError:
        raise SystemExit(f"--shard must be K/N (got {s!r})") from None
    if not 0 <= k < n:
        raise SystemExit(f"--shard K/N needs 0 <= K < N (got {s!r})")
    return k, n
