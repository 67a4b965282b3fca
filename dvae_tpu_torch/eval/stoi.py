"""Short-Time Objective Intelligibility (STOI) and extended STOI (ESTOI):
the port's copy of ``dvae_tpu.eval.stoi``, kept operation for operation so
that its scores are the JAX package's bit for bit.

Native numpy implementation from the published algorithms:

* STOI:  C. Taal et al., "An Algorithm for Intelligibility Prediction of
  Time-Frequency Weighted Noisy Speech", IEEE TASLP 2011.
* ESTOI: J. Jensen, C. Taal, "An Algorithm for Predicting the Intelligibility
  of Speech Masked by Modulated Noise Maskers", IEEE TASLP 2016.

The reference calls the pystoi package with ``extended=True``
(run_metrics.py:22,133); this module reimplements the algorithm with
pystoi-compatible conventions (10 kHz analysis rate, 256/128 Hann frames
zero-padded to 512-pt FFT, 15 third-octave bands from 150 Hz, 40 dB
silent-frame removal, N=30 frame segments, beta = -15 dB clipping for plain
STOI).

One convention genuinely differs between pystoi and the published MATLAB:
the framing fencepost. pystoi frames with ``range(0, len(x) - 256, 128)``
(exclusive stop — utils.stft / remove_silent_frames), which DROPS the frame
starting exactly at ``len(x) - 256``; the MATLAB reference's
``1:K:length(x)-N+1`` includes it. After silent-frame removal the signal
length always lands on that boundary, so pystoi analyzes exactly one fewer
frame than the published algorithm on every input. ``compat="pystoi"``
(default — it is what the reference's metric sweep actually ran) replicates
the dropped frame; ``compat="matlab"`` follows the published papers.

Validation (of the JAX package's module, which this one copies):
tests/test_stoi_vectors.py cross-checks compat="matlab" against
a second, independently-coded oracle written straight from the published
algorithm (agreement < 1e-6 on synthetic and corpus signals), pins frozen
score vectors for both conventions, and auto-compares compat="pystoi"
against pystoi whenever that package is importable.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.signal import resample_poly

FS = 10000
N_FRAME = 256
HOP = 128
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30
BETA = -15.0
DYN_RANGE = 40.0
EPS = np.finfo(np.float64).eps


@functools.lru_cache(maxsize=1)
def _third_octave_matrix():
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    cfs = MIN_FREQ * 2.0 ** (np.arange(NUM_BANDS) / 3.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for i, cf in enumerate(cfs):
        fl = cf / 2 ** (1 / 6)
        fr = cf * 2 ** (1 / 6)
        il = int(np.argmin((f - fl) ** 2))
        ir = int(np.argmin((f - fr) ** 2))
        obm[i, il:ir] = 1.0
    return obm


def _n_frames(length: int, compat: str) -> int:
    stop = length - N_FRAME
    if compat == "matlab":
        return 1 + stop // HOP if stop >= 0 else 0
    # pystoi: len(range(0, stop, HOP)) — an exactly-aligned final frame
    # (stop % HOP == 0) is excluded by the exclusive stop
    return max(0, -(-stop // HOP))


def _frames(x, window, compat):
    n = _n_frames(len(x), compat)
    idx = np.arange(n)[:, None] * HOP + np.arange(N_FRAME)[None, :]
    return x[idx] * window


def _remove_silent_frames(x, y, window, compat):
    xf = _frames(x, window, compat)
    yf = _frames(y, window, compat)
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + EPS)
    keep = energies > np.max(energies) - DYN_RANGE
    xf, yf = xf[keep], yf[keep]
    n = len(xf)
    out_len = (n - 1) * HOP + N_FRAME if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        xs[i * HOP : i * HOP + N_FRAME] += xf[i]
        ys[i * HOP : i * HOP + N_FRAME] += yf[i]
    return xs, ys


def _band_spectrogram(x, window, compat):
    xf = _frames(x, window, compat)
    spec = np.abs(np.fft.rfft(xf, NFFT, axis=1)) ** 2  # (frames, bins)
    return np.sqrt(spec @ _third_octave_matrix().T)  # (frames, bands)


def stoi(x, y, fs_signal: int, extended: bool = True,
         compat: str = "pystoi") -> float:
    """Intelligibility of degraded ``y`` against clean ``x`` in [~0, 1].

    ``compat`` picks the framing fencepost (see module docstring):
    "pystoi" (default) matches what the reference's sweep ran; "matlab"
    matches the published algorithm (one more analysis frame).
    """
    if compat not in ("pystoi", "matlab"):
        raise ValueError(f"bad compat {compat!r} (use 'pystoi' or 'matlab')")
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if len(x) != len(y):
        raise ValueError("x and y must have the same length")
    if fs_signal != FS:
        x = resample_poly(x, FS, fs_signal)
        y = resample_poly(y, FS, fs_signal)

    window = np.hanning(N_FRAME + 2)[1:-1]
    x, y = _remove_silent_frames(x, y, window, compat)

    X = _band_spectrogram(x, window, compat)  # (frames, bands)
    Y = _band_spectrogram(y, window, compat)
    if X.shape[0] < N_SEG:
        # pystoi warns and returns 1e-5 here; raising would abort a whole
        # metrics sweep on one pathological (mostly-silent) utterance
        import warnings

        warnings.warn("signal too short after silent-frame removal; "
                      "returning 1e-5 (pystoi convention)")
        return 1e-5
    m = X.shape[0] - N_SEG + 1

    if extended:
        total = 0.0
        for i in range(m):
            xs = X[i : i + N_SEG].T  # (bands, N)
            ys = Y[i : i + N_SEG].T
            # row (per-band) normalization over time
            xs = xs - xs.mean(axis=1, keepdims=True)
            xs = xs / (np.linalg.norm(xs, axis=1, keepdims=True) + EPS)
            ys = ys - ys.mean(axis=1, keepdims=True)
            ys = ys / (np.linalg.norm(ys, axis=1, keepdims=True) + EPS)
            # column (per-frame) normalization over bands
            xs = xs - xs.mean(axis=0, keepdims=True)
            xs = xs / (np.linalg.norm(xs, axis=0, keepdims=True) + EPS)
            ys = ys - ys.mean(axis=0, keepdims=True)
            ys = ys / (np.linalg.norm(ys, axis=0, keepdims=True) + EPS)
            total += float(np.sum(xs * ys)) / N_SEG
        return total / m

    clip = 10 ** (-BETA / 20)
    total = 0.0
    for i in range(m):
        xs = X[i : i + N_SEG]  # (N, bands)
        ys = Y[i : i + N_SEG]
        alpha = np.linalg.norm(xs, axis=0, keepdims=True) / (
            np.linalg.norm(ys, axis=0, keepdims=True) + EPS
        )
        ys = np.minimum(ys * alpha, xs * (1 + clip))
        xs = xs - xs.mean(axis=0, keepdims=True)
        ys = ys - ys.mean(axis=0, keepdims=True)
        num = np.sum(xs * ys, axis=0)
        den = np.linalg.norm(xs, axis=0) * np.linalg.norm(ys, axis=0) + EPS
        total += float(np.sum(num / den)) / NUM_BANDS
    return total / m
