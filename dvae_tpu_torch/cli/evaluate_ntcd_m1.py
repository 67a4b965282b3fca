"""Enhance the noisy NTCD-TIMIT test set with M1 (port of the JAX package's
``scripts/evaluate_ntcd_M1.py``).

    python -m dvae_tpu_torch.cli.evaluate_ntcd_m1 --data-root data \\
        --model-dir models/ntcd_M1_... --snr all

Walks ``<data-root>/<dataset-size>/processed/`` through the NTCD catalog,
enhances the noisy test utterances in length-sorted batches on the card
(``--platform cpu``: the plain PyTorch path on the CPU) and writes
``<output-dir>/<noisy rel path>_{s,n}_est.wav`` with resume-by-skip. The
checkpoint is a ``.pt`` state_dict. ``--std-norm`` reads HDF5 statistics,
and the catalog's video-trim h5s (when present) are read too, with
``h5py``: a CPU-host path."""

from __future__ import annotations

from dvae_tpu_torch.cli._family import mcem_config_of
from dvae_tpu_torch.cli._sweep import build_enhancer, parse_sweep_args, run_sweep, sweep_parser
from dvae_tpu_torch.enhance.mcem import McemConfig

BUDGET_FIELDS = ("nsamples_e_step", "burnin_e_step", "nsamples_wf", "burnin_wf")


def parse_args(argv=None):
    ap = sweep_parser("python -m dvae_tpu_torch.cli.evaluate_ntcd_m1", __doc__)
    ap.add_argument("--m1-reference-budgets", action="store_true",
                    help="use the MH budgets the reference's MCEM_M1 actually runs "
                         "(E-step 30/30, WF 75/30) rather than its nominal settings; "
                         "explicit budget flags override the matching fields")
    return parse_sweep_args(ap, argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    mcem = None
    if args.m1_reference_budgets:
        eff = McemConfig.m1_reference_effective()
        mcem = mcem_config_of(args, **{
            f: getattr(eff, f) if getattr(args, f) is None else getattr(args, f)
            for f in BUDGET_FIELDS})
    enh, out_dir, _ = build_enhancer(args, "m1", mcem=mcem)
    return run_sweep(args, enh, out_dir)


if __name__ == "__main__":
    main()
