"""Train M2-info warm-started from a pretrained classifier (port of the
JAX package's ``scripts/training_M2_info_vad_pretrain.py``).

    python -m dvae_tpu_torch.cli.training_m2_info_vad_pretrain --frames <.npz> \\
        --pretrained-checkpoint models/<run>/M2_epoch_010_vloss_....pt

The weights start Xavier-normal from ``--seed``; the ``enc_dec_clf.classifier``
entries of ``--pretrained-checkpoint`` (a port ``.pt``) replace theirs
(``checkpoint.partial_load``, reference :103-113), and the decoder is
conditioned on the classifier's soft prediction (reference :163).
``--gamma`` defaults to ``--beta`` (the reference's auxiliary trains on
``beta * BCE``); ``--freeze-classifier`` keeps the loaded classifier
fixed. Runs on the card (``--platform cpu``: the plain PyTorch path)."""

from __future__ import annotations

import torch

from dvae_tpu_torch.cli import _train
from dvae_tpu_torch.cli.training_m2_info_vad import VTAGS
from dvae_tpu_torch.models import DisentangledVAE
from dvae_tpu_torch.models.blocks import init_xavier_
from dvae_tpu_torch.train import checkpoint as ckpt
from dvae_tpu_torch.train.loop import fit_adversarial


def run_name(args, gamma: float) -> str:
    """``ntcd_M2_info_VAD_Lenc_aux_vN_alpha_{a}_beta_{b}[_gamma_{g}]_pretrain_
    yhatsoft_...``: the gamma segment only when ``--gamma`` was given."""
    if args.run_name:
        return args.run_name
    norm = "norm" if args.std_norm else "nonorm"
    gamma_seg = "" if args.gamma is None else f"_gamma_{gamma}"
    return (f"ntcd_M2_info_VAD_Lenc_aux_{VTAGS[args.enc_adversary]}_alpha_{args.alpha}"
            f"_beta_{args.beta}{gamma_seg}_pretrain_yhatsoft_{norm}"
            f"_hdim_{_train.hdim_tag(args)}_zdim_{args.z_dim:03d}"
            f"_end_epoch_{args.end_epoch:03d}")


def main(argv=None):
    ap = _train.training_parser(
        "python -m dvae_tpu_torch.cli.training_m2_info_vad_pretrain", __doc__)
    ap.add_argument("--alpha", type=float, default=0.0)
    ap.add_argument("--beta", type=float, default=10.0)
    ap.add_argument("--gamma", type=float, default=None,
                    help="the auxiliary's objective weight (default: --beta)")
    ap.add_argument("--pretrained-checkpoint", required=True,
                    help="the .pt to load the classifier from")
    ap.add_argument("--freeze-classifier", action="store_true")
    ap.add_argument("--legacy-aux-coupling", action="store_true")
    ap.add_argument("--enc-adversary", default="entropy",
                    choices=["entropy", "bce", "uniform"],
                    help="the encoder's -beta adversary term; default 'entropy', the "
                         "reference pretrain script's (name tag Lenc_aux_v3)")
    args = _train.parse_training(ap, argv)
    train_ds, valid_ds = _train.datasets(args)
    model = DisentangledVAE(x_dim=513, y_dim=1, z_dim=args.z_dim, h_dim=tuple(args.h_dim))
    init_xavier_(model, torch.Generator().manual_seed(args.seed))
    ckpt.partial_load(args.pretrained_checkpoint, model, "enc_dec_clf.classifier")
    gamma = args.beta if args.gamma is None else args.gamma
    model_name = run_name(args, gamma)
    print(f"training {model_name} (warm-started classifier)")
    return fit_adversarial(model, train_ds, valid_ds, _train.model_dir(args, model_name), "M2",
                           alpha=args.alpha, beta=args.beta, gamma=gamma,
                           cfg=_train.loop_config(args),
                           init_state_dict={k: v.clone() for k, v in model.state_dict().items()},
                           legacy_aux_coupling=args.legacy_aux_coupling, use_y_hat_soft=True,
                           freeze_classifier=args.freeze_classifier,
                           enc_adversary=args.enc_adversary, device=args.platform,
                           mesh=args.mesh)


if __name__ == "__main__":
    main()
