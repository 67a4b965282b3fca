"""PESQ / POLQA dispatch and gating (port of ``dvae_tpu.eval.pesq``).

PESQ (ITU-T P.862) and POLQA (P.863) are licensed algorithms the reference
consumes through external packages — ``pesq`` from PyPI (run_metrics.py:23)
and the proprietary ``uhh_sp.evaluation.polqa`` (run_metrics.py:24).

* PESQ (wideband AND narrowband) is always available: if the licensed
  ``pesq`` wheel is importable it is preferred (bit-conformant to ITU);
  otherwise the native implementation in
  :mod:`dvae_tpu_torch.eval.pesq_native` scores the pair (same pipeline
  structure with the P.862.2/'wb' or P.862.1/'nb' mapping; not
  bit-conformant — see its module docstring).
* POLQA remains gated on its proprietary package: calls raise a clear
  error and the metric sweeps skip the column (run_metrics 'n/a').
"""

from __future__ import annotations

import os

import numpy as np


def pesq_wheel_available() -> bool:
    """True iff the licensed PyPI ``pesq`` wheel is importable."""
    try:
        import pesq  # noqa: F401

        return True
    except ImportError:
        return False


def pesq_available() -> bool:
    """Wideband PESQ is always measurable (native fallback)."""
    return True


def pesq(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str = "wb") -> float:
    """PESQ MOS-LQO (run_metrics.py:137: ``pesq(fs, s, s_hat, 'wb')``).

    Prefers the licensed wheel; falls back to the native implementation
    (P.862.2 mapping for 'wb', P.862.1 for 'nb').
    """
    if mode not in ("wb", "nb"):
        raise ValueError(f"unknown PESQ mode {mode!r} (use 'wb' or 'nb')")
    try:
        from pesq import pesq as _pesq
    except ImportError:
        from dvae_tpu_torch.eval.pesq_native import pesq_nb, pesq_wb

        return (pesq_wb if mode == "wb" else pesq_nb)(ref, deg, fs)
    return _pesq(fs, ref, deg, mode)


def polqa_available() -> bool:
    try:
        from uhh_sp.evaluation import polqa  # noqa: F401

        return True
    except ImportError:
        return False


def polqa(ref_paths, deg_paths):
    """Batch POLQA through the proprietary uhh_sp package.

    Invoked exactly as the reference does (run_metrics.py:448-453):
    wideband MOS only, narrowband disabled, 2 workers. Returns one
    wideband score per pair — uhh_sp items are (id, score)-style
    sequences with the score at index 1 (the reference consumes
    ``sub_list[1]``, run_metrics.py:477); scalars pass through.
    """
    try:
        from uhh_sp.evaluation import polqa as _polqa
    except ImportError as e:
        raise RuntimeError(
            "POLQA requires the proprietary `uhh_sp` package (ITU-T P.863); "
            "not installed in this environment."
        ) from e
    out = _polqa(v_reference=ref_paths, v_processed=deg_paths,
                 narrowband=False, wideband=True, n_workers=2)
    return [float(item if np.isscalar(item) else item[1]) for item in out]


def polqa_prepare_pairs(pairs, pad_dir, min_sec: float = 3.0):
    """Split (ref, deg) wav-path pairs into POLQA-ready lists.

    POLQA rejects signals shorter than ~3 s; the reference works around it by
    zero-padding short pairs to exactly 3 s and scoring them as a separate
    "extended" batch (run_metrics.py:398-424, files suffixed ``_3sec``).
    Replicated here as a pure, testable step — with one deliberate change:
    the reference writes the padded CLEAN copy back into the data tree, which
    may be a read-only corpus; both padded copies go under ``pad_dir``
    (the model output dir) instead.

    Returns (normal_pairs, extended_pairs); extended pairs point at the
    padded copies that were written.
    """
    from dvae_tpu_torch.data.io import read_wav, write_wav

    normal, extended = [], []
    os.makedirs(pad_dir, exist_ok=True)
    for ref_path, deg_path in pairs:
        ref, fs_r = read_wav(ref_path)
        deg, fs_d = read_wav(deg_path)
        if fs_d != fs_r:
            raise ValueError(
                f"sample-rate mismatch: {ref_path} is {fs_r} Hz but "
                f"{deg_path} is {fs_d} Hz — POLQA pairs must share a rate"
            )
        # the 3 s threshold is in samples of the pair's ACTUAL rate
        target = int(round(min_sec * fs_r))
        if len(ref) >= target:
            normal.append((ref_path, deg_path))
            continue
        ref = np.pad(ref, (0, target - len(ref)))
        deg = np.pad(deg, (0, max(0, target - len(deg))))
        # NTCD utterance ids (sa1, si*) repeat across speaker/noise/SNR
        # directories — a basename-only name would collide and clobber.
        # Encode the tail of the degraded path into the copy's name.
        parts = os.path.normpath(deg_path).split(os.sep)[-5:]
        stem = os.path.splitext("__".join(p for p in parts if p))[0]
        ref_out = os.path.join(pad_dir, f"{stem}_s_3sec.wav")
        deg_out = os.path.join(pad_dir, f"{stem}_3sec.wav")
        write_wav(ref_out, ref, fs_r)
        write_wav(deg_out, deg, fs_r)
        extended.append((ref_out, deg_out))
    return normal, extended
