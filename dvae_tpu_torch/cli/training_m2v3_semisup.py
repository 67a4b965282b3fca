"""Train the M2v3 CVAE on the semi-supervised U_loss / L_loss objective
(port of the JAX package's ``scripts/training_M2v3_semisup.py``).

    python -m dvae_tpu_torch.cli.training_m2v3_semisup --objective uloss \\
        --alpha -10 --y-cond hardlabel --frames <.npz>
    -> ntcd_M2v3_VAD_Uloss_alpha_-10.0_hardlabel_nonorm_hdim_128_128_zdim_016_...

The reconstructed trainer behind the reference's ``ntcd_M2v3_VAD_*``
checkpoints (``dvae_tpu_torch.train.steps.make_semisup_step``). Every such
checkpoint is 'nonorm', so ``--std-norm`` is a parse error. Runs on the
card (``--platform cpu``: the plain PyTorch path)."""

from __future__ import annotations

from dvae_tpu_torch.cli import _train
from dvae_tpu_torch.cli._family import y_dim_for
from dvae_tpu_torch.models import CVAE_v3
from dvae_tpu_torch.train.loop import fit_semisup


def main(argv=None):
    ap = _train.training_parser("python -m dvae_tpu_torch.cli.training_m2v3_semisup", __doc__)
    ap.add_argument("--objective", default="uloss", choices=["uloss", "lloss"])
    ap.add_argument("--alpha", type=float, default=0.0,
                    help="weight of the -alpha * BCE(y_hat, y) classifier term")
    ap.add_argument("--y-cond", default="soft",
                    choices=["soft", "yhathard", "hardlabel", "ytrue"],
                    help="the decoder's conditioning label (see make_semisup_step)")
    args = _train.parse_training(ap, argv)
    if args.std_norm:
        ap.error("--std-norm is not supported here (all golden Uloss/Lloss "
                 "checkpoints are 'nonorm')")
    train_ds, valid_ds = _train.datasets(args)
    y_dim = y_dim_for(args.labels)
    model = CVAE_v3(x_dim=513, y_dim=y_dim, z_dim=args.z_dim, h_dim=tuple(args.h_dim))
    lab = "VAD" if args.labels == "vad_labels" else "IBM"
    obj = "Uloss" if args.objective == "uloss" else "Lloss"
    cond_suffix = {"soft": "", "yhathard": "_yhathard", "hardlabel": "_hardlabel",
                   "ytrue": "_ytrue"}[args.y_cond]
    model_name = _train.mangle("ntcd_M2v3", args,
                               extra=f"{lab}_{obj}_alpha_{args.alpha:.1f}{cond_suffix}")
    print(f"training {model_name} (objective={args.objective}, alpha={args.alpha}, "
          f"y_cond={args.y_cond})")
    return fit_semisup(model, train_ds, valid_ds, _train.model_dir(args, model_name), "M2",
                       objective=args.objective, alpha=args.alpha, y_cond=args.y_cond,
                       cfg=_train.loop_config(args), device=args.platform,
                       mesh=args.mesh)


if __name__ == "__main__":
    main()
