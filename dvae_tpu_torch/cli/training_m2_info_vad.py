"""Train the disentangled M2-info model by the two-optimizer adversarial
game (port of the JAX package's ``scripts/training_M2_info_vad.py``).

    python -m dvae_tpu_torch.cli.training_m2_info_vad --frames <.npz>

The encoder, decoder and x -> y classifier minimize ``ELBO + alpha *
BCE(y_hat_x, y) - beta * adversary(y_hat_z, y)``; the z -> y auxiliary
trains on ``gamma * BCE`` of the detached latents
(``dvae_tpu_torch.train.steps.make_adversarial_step``, also for
``--legacy-aux-coupling``). ``--model-variant v4`` trains the flat
``CVAE_v4`` of the reference's ``ntcd_M2v4_*`` family. Runs on the card
(``--platform cpu``: the plain PyTorch path)."""

from __future__ import annotations

from dvae_tpu_torch.cli import _train
from dvae_tpu_torch.models import CVAE_v4, DisentangledVAE
from dvae_tpu_torch.train.loop import fit_adversarial

VTAGS = {"bce": "v1", "uniform": "v2", "entropy": "v3"}
COND_SUFFIX = {"ytrue": "", "soft": "_ysoft", "yhathard": "_yhathard",
               "hardlabel": "_hardlabel"}


def run_name(args) -> str:
    """The two grammars of the reference's names: v4's
    ``ntcd_M2v4_VAD_alpha_{a}_beta_{b}[cond][_Lenc_aux_vN]_...`` (gamma not
    in the name, the adversary's tag only when it is not 'bce') and v5's
    ``ntcd_M2_info_VAD_Lenc_aux_vN_alpha_{a}_beta_{b}_gamma_{g}_y[cond]_...``."""
    if args.run_name:
        return args.run_name
    norm = "norm" if args.std_norm else "nonorm"
    tail = f"_{norm}_hdim_{_train.hdim_tag(args)}_zdim_{args.z_dim:03d}" \
           f"_end_epoch_{args.end_epoch:03d}"
    vtag, cond = VTAGS[args.enc_adversary], COND_SUFFIX[args.y_cond]
    if args.model_variant == "v4":
        adv = "" if args.enc_adversary == "bce" else f"_Lenc_aux_{vtag}"
        return f"ntcd_M2v4_VAD_alpha_{args.alpha}_beta_{args.beta}{cond}{adv}{tail}"
    return (f"ntcd_M2_info_VAD_Lenc_aux_{vtag}_alpha_{args.alpha}_beta_{args.beta}"
            f"_gamma_{args.gamma}_y{cond}{tail}")


def main(argv=None):
    ap = _train.training_parser("python -m dvae_tpu_torch.cli.training_m2_info_vad", __doc__)
    ap.add_argument("--alpha", type=float, default=0.0)
    ap.add_argument("--beta", type=float, default=10.0)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--legacy-aux-coupling", action="store_true")
    ap.add_argument("--enc-adversary", default="bce", choices=["bce", "uniform", "entropy"],
                    help="the encoder's -beta adversary term: 'bce' (labelled, name "
                         "tag Lenc_aux_v1), 'uniform' (v2) or 'entropy' (v3)")
    ap.add_argument("--model-variant", default="v5", choices=["v5", "v4"],
                    help="v5 = DisentangledVAE; v4 = the flat CVAE_v4")
    ap.add_argument("--y-cond", default="ytrue",
                    choices=["ytrue", "soft", "yhathard", "hardlabel"],
                    help="the decoder's conditioning label")
    args = _train.parse_training(ap, argv)
    train_ds, valid_ds = _train.datasets(args)
    model_cls = DisentangledVAE if args.model_variant == "v5" else CVAE_v4
    model = model_cls(x_dim=513, y_dim=1, z_dim=args.z_dim, h_dim=tuple(args.h_dim))
    model_name = run_name(args)
    print(f"training {model_name}")
    return fit_adversarial(model, train_ds, valid_ds, _train.model_dir(args, model_name), "M2",
                           alpha=args.alpha, beta=args.beta, gamma=args.gamma,
                           cfg=_train.loop_config(args),
                           legacy_aux_coupling=args.legacy_aux_coupling,
                           y_cond=args.y_cond, enc_adversary=args.enc_adversary,
                           device=args.platform, mesh=args.mesh)


if __name__ == "__main__":
    main()
