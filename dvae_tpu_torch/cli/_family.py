"""Flags and loaders shared by the port's serving CLIs: the model family
of a checkpoint and the MCEM budgets (the port's copy of the parts of the
JAX package's ``scripts/_lib.py`` that these CLIs need).

Checkpoints are ``.pt`` state_dicts in the reference's names: a
reference checkpoint, one the port's trainers wrote, or a JAX ``.msgpack``
converted once on a CPU host with ``scripts/export_torch_checkpoint.py``.
"""

from __future__ import annotations

import argparse
import pathlib

from dvae_tpu_torch.enhance.mcem import McemConfig
from dvae_tpu_torch.models import CVAE, CVAE_v2, CVAE_v3, CVAE_v4, VAE, DisentangledVAE
from dvae_tpu_torch.train import checkpoint as ckpt

FAMILIES = {"m1": VAE, "m2": CVAE, "m2v2": CVAE_v2, "v3": CVAE_v3, "v4": CVAE_v4,
            "v5": DisentangledVAE}


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
    """The MCEM sampling budgets (None = the ``McemConfig`` default) and
    the E-step engine."""
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
    ap.add_argument("--engine", choices=("mcem", "peem", "peem-wf", "pmcem"), default="mcem",
                    help="E-step inference; this port serves 'mcem' (the "
                         "reference's Metropolis-Hastings Monte-Carlo EM) only")
    return ap


def mcem_config_of(args) -> McemConfig:
    """``McemConfig`` from the ``add_mcem_budgets`` flags."""
    kw = dict(niter=args.niter, nmf_rank=args.nmf_rank)
    for field in ("nsamples_e_step", "burnin_e_step", "nsamples_wf", "burnin_wf", "var_rw"):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    return McemConfig(**kw)
