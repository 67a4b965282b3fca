"""Enhance the noisy NTCD-TIMIT test set with M2, the label-conditioned
VAE (port of the JAX package's ``scripts/evaluate_ntcd_M2.py``).

    python -m dvae_tpu_torch.cli.evaluate_ntcd_m2 --data-root data \\
        --labels vad_labels --model-dir models/ntcd_M2_... --snr all

``--model-variant v1`` is ``CVAE`` (the encoder sees [x; y]), ``v2`` is
``CVAE_v2`` (the encoder sees x only). Labels: the oracle label h5s, a
classifier's precomputed ``*_y_hat_hard.pt/.npy``, or the constant
ablations. Outputs and device as in ``evaluate_ntcd_m1``; the oracle and
constant sources read the label h5s with ``h5py``, a CPU-host path."""

from __future__ import annotations

from dvae_tpu_torch.cli._family import warn_peem_family, y_dim_for
from dvae_tpu_torch.cli._sweep import (
    add_label_source,
    build_enhancer,
    label_loader,
    parse_sweep_args,
    run_sweep,
    sweep_parser,
)

SUFFIX = {"oracle": "", "classifier": "_y_hat_hard", "ones": "_oracle_1", "zeros": "_oracle_0"}


def parse_args(argv=None):
    ap = sweep_parser("python -m dvae_tpu_torch.cli.evaluate_ntcd_m2", __doc__)
    add_label_source(ap, list(SUFFIX))
    ap.add_argument("--model-variant", default="v1", choices=["v1", "v2"],
                    help="v1 = CVAE (encoder sees [x; y], MCEM_M2 semantics); "
                         "v2 = CVAE_v2 (encoder on x only, MCEM_M2v2 semantics)")
    args = parse_sweep_args(ap, argv)
    if args.y_source == "classifier" and not args.classifier_dir:
        ap.error("--y-source classifier requires --classifier-dir")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    y_dim = y_dim_for(args.labels)
    model_class = "m2" if args.model_variant == "v1" else "m2v2"
    warn_peem_family(args, model_class, y_dim)
    enh, out_dir, _ = build_enhancer(args, model_class, y_dim,
                                     "enc_dec" if args.model_variant == "v1" else "dec_only")
    return run_sweep(args, enh, out_dir, label_loader(args, y_dim), SUFFIX[args.y_source])


if __name__ == "__main__":
    main()
