"""Train the M2 conditional VAE, encoder([x; y]) and decoder([z; y])
(port of the JAX package's ``scripts/training_M2.py``).

    python -m dvae_tpu_torch.cli.training_m2 --labels ibm_labels --frames <.npz>

y is the VAD label (y_dim 1) or the IBM (y_dim 513) by ``--labels``.
``--model-variant v2`` trains ``CVAE_v2`` (the encoder sees x only, the
reference's ``ntcd_M2v2_*`` family). Runs on the card (``--platform cpu``:
the plain PyTorch path)."""

from __future__ import annotations

from dvae_tpu_torch.cli import _train
from dvae_tpu_torch.cli._family import y_dim_for
from dvae_tpu_torch.models import CVAE, CVAE_v2
from dvae_tpu_torch.train.loop import fit_vae


def main(argv=None):
    ap = _train.training_parser("python -m dvae_tpu_torch.cli.training_m2", __doc__)
    ap.add_argument("--model-variant", default="v1", choices=["v1", "v2"],
                    help="v1 = CVAE (the encoder sees [x; y]); v2 = CVAE_v2 (the "
                         "encoder sees x only)")
    args = _train.parse_training(ap, argv)
    train_ds, valid_ds = _train.datasets(args)
    y_dim = y_dim_for(args.labels)
    model_cls = CVAE if args.model_variant == "v1" else CVAE_v2
    model = model_cls(x_dim=513, y_dim=y_dim, z_dim=args.z_dim, h_dim=tuple(args.h_dim))
    lab = "VAD" if args.labels == "vad_labels" else "IBM"
    prefix = "ntcd_M2" if args.model_variant == "v1" else "ntcd_M2v2"
    model_name = _train.mangle(prefix, args, extra=lab)
    print(f"training {model_name} (y_dim={y_dim})")
    return fit_vae(model, train_ds, valid_ds, _train.model_dir(args, model_name), "M2",
                   conditional=True, cfg=_train.loop_config(args), device=args.platform,
                   mesh=args.mesh)


if __name__ == "__main__":
    main()
