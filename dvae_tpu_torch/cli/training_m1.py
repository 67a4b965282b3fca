"""Train the M1 plain VAE on clean power-spectrogram frames (port of the
JAX package's ``scripts/training_M1.py``).

    python -m dvae_tpu_torch.cli.training_m1 --data-root data \\
        --frames data/subset/processed/ntcd_timit/Clean_vad_labels_upsampled.npz

Batch 128, Adam 1e-4, the Itakura-Saito ELBO, per-epoch validation and a
checkpoint ``M1_epoch_xxx_vloss_yy.yy.pt`` under
``<models-root>/ntcd_M1_<norm>_hdim_..._end_epoch_...``. Runs on the card
(``--platform cpu``: the plain PyTorch path); ``--steps-per-dispatch K``
replays one CUDA graph per K steps there."""

from __future__ import annotations

from dvae_tpu_torch.cli import _train
from dvae_tpu_torch.models import VAE
from dvae_tpu_torch.train.loop import fit_vae


def main(argv=None):
    ap = _train.training_parser("python -m dvae_tpu_torch.cli.training_m1", __doc__)
    args = _train.parse_training(ap, argv)
    train_ds, valid_ds = _train.datasets(args)
    model = VAE(x_dim=513, z_dim=args.z_dim, h_dim=tuple(args.h_dim))
    model_name = _train.mangle("ntcd_M1", args)
    print(f"training {model_name} on {args.frames} ({len(train_ds)} frames)")
    return fit_vae(model, train_ds, valid_ds, _train.model_dir(args, model_name), "M1",
                   conditional=False, cfg=_train.loop_config(args), device=args.platform,
                   mesh=args.mesh)


if __name__ == "__main__":
    main()
