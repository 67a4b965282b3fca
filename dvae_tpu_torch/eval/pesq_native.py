"""Native PESQ — ITU-T P.862 perceptual model; wideband (P.862.2) and
narrowband (P.862.1) output mappings. The port's copy of
``dvae_tpu.eval.pesq_native``, kept operation for operation so that its
scores are the JAX package's bit for bit.

The reference scores enhancement with the licensed ``pesq`` wheel
(run_metrics.py:23,137 — ``pesq(fs, s, s_hat, 'wb')``), which a machine may
lack. This module is a from-scratch numpy implementation of the P.862
pipeline, so that the headline metric stays measurable without it:

1.  level alignment of both signals to a fixed active-band power
    (350-3250 Hz, the P.862 calibration band);
2.  the input filter: P.862.2 wideband mode uses a 100 Hz high-pass;
    narrowband uses an IRS-receive-like 300-3400 Hz band-pass;
3.  time alignment: crude delay from 4 ms energy-envelope correlation,
    refined by full-rate cross-correlation (our enhancement outputs are
    sample-aligned by construction, so the P.862 per-utterance re-alignment
    recursion is deliberately omitted);
4.  perceptual model: 32 ms Hann frames (512 @ 16 kHz / 256 @ 8 kHz, 50%
    overlap) -> power spectra -> Bark bands (z = 7·asinh(f/650), uniform in
    Bark; 49 bands wideband, 42 narrowband) -> partial frequency-response
    equalization of the reference (±20 dB bound) -> smoothed short-term gain
    equalization of the degraded (bound [3e-4, 5], 1st-order smoothing
    0.8/0.2) -> Zwicker loudness S ∝ (P0/0.5)^0.23·[(0.5+0.5·P/P0)^0.23−1]
    above a hearing threshold;
5.  disturbance: |L_deg − L_ref| shrunk by the 0.25·min masking deadzone;
    asymmetric disturbance scaled by ((B_deg+50)/(B_ref+50))^1.2 with the
    <3 -> 0 gate and cap at 12;
6.  aggregation: weighted L2 (symmetric) / L1 (asymmetric) over bands,
    frame disturbances de-emphasized by (P_ref+1e5)^0.04 and capped, then
    L6 over 20-frame split-second windows and L2 over windows;
7.  raw score 4.5 − 0.1·D − 0.0309·DA, mapped to MOS-LQO by the published
    logistic: P.862.2 wideband  y = 0.999 + 4.0/(1+exp(−1.3669·x+3.8224));
    P.862.1 narrowband          y = 0.999 + 4.0/(1+exp(−1.4945·x+4.6607)).

Conformance caveat (documented, deliberate): the ITU band tables
(centre/width/threshold per band) and the conformance test vectors are not
redistributable and not shipped with the repo, so the Bark layout and
hearing threshold are derived analytically (asinh Bark warp,
Terhardt absolute-threshold curve) and the narrowband IRS filter is a
band-pass approximation. Scores are deterministic, correctly anchored
(identical signals -> 4.64 wb / 4.55 nb, the published maxima) and monotone
in distortion (tests/test_pesq_native.py pins the JAX package's golden-wav
values and orderings), but are not bit-identical to the licensed
implementation. ``eval.pesq.pesq`` prefers the licensed wheel whenever it is
importable.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
from scipy.signal import butter, sosfilt

TARGET_POWER = 1e7          # active-band power after level alignment
SILENCE_FLOOR = 1e5         # frame considered speech-active above this
EPS = 1e-12
_ZWICKER = 0.23
# CAL absorbs the difference between the ITU loudness tables and the
# analytic Bark/threshold derivation: chosen once so white-noise degradation
# of speech-like signals tracks published wideband PESQ behavior (measured
# curve: 1.08 @ 0 dB SNR, 1.29 @ 10, 1.87 @ 20, 3.71 @ 30, 4.49 @ 40;
# tests/test_pesq_native.py pins it)
CAL = 0.6


def _bark(f):
    return 7.0 * np.arcsinh(np.asarray(f, dtype=np.float64) / 650.0)


def _inv_bark(z):
    return 650.0 * np.sinh(np.asarray(z, dtype=np.float64) / 7.0)


@dataclasses.dataclass(frozen=True)
class _Mode:
    fs: int
    nf: int           # frame length (32 ms), hop = nf // 2
    nb: int           # Bark bands
    band_mat: np.ndarray
    abs_thresh: np.ndarray
    input_sos: np.ndarray
    map_a: float      # MOS-LQO logistic slope
    map_b: float      # MOS-LQO logistic offset


@functools.lru_cache(maxsize=2)
def _get_mode(name: str) -> _Mode:
    if name == "wb":
        fs, nf, nb, f_lo, f_hi = 16000, 512, 49, 100.0, 8000.0
        input_sos = butter(3, 100.0, btype="high", fs=fs, output="sos")
        map_a, map_b = 1.3669, 3.8224          # P.862.2
    elif name == "nb":
        fs, nf, nb, f_lo, f_hi = 8000, 256, 42, 100.0, 4000.0
        # IRS receive characteristic approximated by a 300-3400 band-pass
        input_sos = butter(3, [300.0, 3400.0], btype="band", fs=fs,
                           output="sos")
        map_a, map_b = 1.4945, 4.6607          # P.862.1
    else:
        raise ValueError(f"unknown PESQ mode {name!r} (use 'wb' or 'nb')")

    freqs = np.fft.rfftfreq(nf, d=1.0 / fs)
    edges = _inv_bark(np.linspace(_bark(f_lo), _bark(f_hi), nb + 1))
    centres = np.sqrt(edges[:-1] * edges[1:])
    mat = np.zeros((nb, freqs.size))
    idx = np.searchsorted(edges, freqs, side="right") - 1
    for b in range(nb):
        sel = idx == b
        n = int(np.count_nonzero(sel))
        if n:
            mat[b, sel] = 1.0 / n

    # Terhardt absolute threshold of hearing (dB SPL re the aligned level
    # scale: TARGET_POWER active speech ~ 79 dB SPL => 0 dB ~ TARGET/10^7.9)
    khz = centres / 1000.0
    thresh_db = (3.64 * khz ** -0.8
                 - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
                 + 1e-3 * khz ** 4)
    abs_thresh = TARGET_POWER / 10 ** 7.9 * 10 ** (thresh_db / 10.0)
    return _Mode(fs, nf, nb, mat, abs_thresh, input_sos, map_a, map_b)


def _level_align(x, fs):
    """Scale so the 350-3250 Hz band carries TARGET_POWER average power."""
    sos = butter(4, [350.0, 3250.0], btype="band", fs=fs, output="sos")
    band = sosfilt(sos, x)
    p = float(np.mean(band * band))
    return x * np.sqrt(TARGET_POWER / max(p, EPS))


def _estimate_delay(ref, deg, fs, max_ms=250.0):
    """Delay of ``deg`` relative to ``ref`` in samples.

    Crude stage: cross-correlation of 4 ms energy envelopes (P.862's
    envelope-based alignment); fine stage: full-rate FFT cross-correlation
    in a ±125 ms window around the crude estimate (the energy envelope of
    quasi-periodic speech is broad, so the crude stage can be off by
    several pitch periods)."""
    hop = int(0.004 * fs)
    n = min(len(ref), len(deg)) // hop
    if n < 8:
        return 0
    er = np.log1p(np.sum(ref[: n * hop].reshape(n, hop) ** 2, axis=1))
    ed = np.log1p(np.sum(deg[: n * hop].reshape(n, hop) ** 2, axis=1))
    er -= er.mean()
    ed -= ed.mean()
    max_lag = min(int(max_ms / 4.0), n - 2)
    xc = np.correlate(ed, er, mode="full")
    lags = np.arange(-(n - 1), n)
    keep = np.abs(lags) <= max_lag
    crude = int(lags[keep][np.argmax(xc[keep])]) * hop

    m = min(len(ref), len(deg))
    nfft = 1 << int(np.ceil(np.log2(2 * m)))
    corr = np.fft.irfft(
        np.fft.rfft(deg[:m], nfft) * np.conj(np.fft.rfft(ref[:m], nfft)), nfft
    )  # corr[k % nfft] = sum_n ref[n] * deg[n + k]
    win = int(0.125 * fs)
    cand = np.arange(crude - win, crude + win + 1)
    cand = cand[(cand > -m) & (cand < m)]
    return int(cand[np.argmax(corr[cand % nfft])])


def _bark_power(x, mode: _Mode):
    """(frames, NB) Bark-band power densities."""
    nf, hop = mode.nf, mode.nf // 2
    n = 1 + max(0, (len(x) - nf)) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(nf)[None, :]
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nf) / nf))
    spec = np.abs(np.fft.rfft(x[idx] * w, axis=1)) ** 2
    # Sp-style scaling: normalize the FFT so a full-scale aligned signal
    # lands on the TARGET_POWER scale per frame
    spec *= 4.0 / nf ** 2
    return spec @ mode.band_mat.T


def _loudness(bark_pow, mode: _Mode):
    p0 = mode.abs_thresh[None, :]
    s = (p0 / 0.5) ** _ZWICKER * (
        (0.5 + 0.5 * bark_pow / p0) ** _ZWICKER - 1.0
    )
    return np.where(bark_pow > p0, s, 0.0)


def _score(ref, deg, fs: int, mode_name: str) -> float:
    mode = _get_mode(mode_name)
    ref = np.asarray(ref, dtype=np.float64)
    deg = np.asarray(deg, dtype=np.float64)
    if fs != mode.fs:
        from scipy.signal import resample_poly

        g = np.gcd(int(fs), mode.fs)
        ref = resample_poly(ref, mode.fs // g, fs // g)
        deg = resample_poly(deg, mode.fs // g, fs // g)

    ref = sosfilt(mode.input_sos, _level_align(ref, mode.fs))
    deg = sosfilt(mode.input_sos, _level_align(deg, mode.fs))

    d = _estimate_delay(ref, deg, mode.fs)
    if d > 0:
        deg = deg[d:]
    elif d < 0:
        ref = ref[-d:]
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if n < mode.nf:
        raise ValueError(f"signals too short for PESQ ({n} samples < {mode.nf})")

    br = _bark_power(ref, mode)
    bd = _bark_power(deg, mode)

    total_r = br.sum(axis=1)
    active = total_r > SILENCE_FLOOR

    # partial frequency-response equalization (applied to the reference)
    if np.any(active):
        mean_r = br[active].mean(axis=0)
        mean_d = bd[active].mean(axis=0)
        ratio = np.clip((mean_d + 1e3) / (mean_r + 1e3), 1e-2, 1e2)
        br = br * ratio[None, :]

    # smoothed short-term gain equalization (applied to the degraded)
    g_raw = np.clip(
        (br.sum(axis=1) + 5e3) / (bd.sum(axis=1) + 5e3), 3e-4, 5.0
    )
    g = np.empty_like(g_raw)
    prev = 1.0
    for t in range(g_raw.size):  # 1st-order IIR; frame count is small
        prev = 0.8 * prev + 0.2 * g_raw[t]
        g[t] = prev
    bd = bd * g[:, None]

    lr = _loudness(br, mode)
    ld = _loudness(bd, mode)

    # symmetric disturbance with masking deadzone
    delta = ld - lr
    mask = 0.25 * np.minimum(ld, lr)
    dist = np.sign(delta) * np.maximum(np.abs(delta) - mask, 0.0)

    # asymmetric disturbance
    h = ((bd + 50.0) / (br + 50.0)) ** 1.2
    h = np.where(h < 3.0, 0.0, np.minimum(h, 12.0))
    dist_a = dist * h

    # Uniform band weights: P.862 weights each band by its width on the
    # (modified) Bark scale, and _get_mode constructs the bands uniform in
    # Bark width by design — so the faithful weighting here IS uniform.
    # (band_mat rows mean-pool their bins, so they all sum to 1; weighting
    # by bin counts instead would double-count the Hz->Bark warping.)
    w = np.full(mode.nb, 1.0 / mode.nb)
    frame_d = np.sqrt(np.sum(w[None, :] * dist ** 2, axis=1) * mode.nb)
    frame_da = np.sum(w[None, :] * np.abs(dist_a), axis=1) * np.sqrt(mode.nb)

    # de-emphasize low-loudness frames, cap hard hits (P.862 caps at 45)
    weight = ((total_r + 1e5) / 1e7) ** 0.04
    frame_d = np.minimum(CAL * frame_d / weight, 45.0)
    frame_da = np.minimum(CAL * frame_da / weight, 45.0)

    def _lp_aggregate(fd):
        if fd.size == 0:
            return 0.0
        win, hop = 20, 10
        if fd.size <= win:
            chunks = [fd]
        else:
            starts = list(range(0, fd.size - win + 1, hop))
            if starts[-1] + win < fd.size:
                # tail frames past the last aligned window still count
                # (P.862 covers the whole utterance with its split-second
                # intervals): one extra full window anchored at the end
                starts.append(fd.size - win)
            chunks = [fd[i : i + win] for i in starts]
        l6 = np.array([np.mean(c ** 6.0) ** (1.0 / 6.0) for c in chunks])
        return float(np.sqrt(np.mean(l6 ** 2)))

    raw = 4.5 - 0.1 * _lp_aggregate(frame_d) - 0.0309 * _lp_aggregate(frame_da)
    return float(0.999 + 4.0 / (1.0 + np.exp(-mode.map_a * raw + mode.map_b)))


def pesq_wb(ref, deg, fs: int = 16000) -> float:
    """Wideband PESQ MOS-LQO (P.862.2 mapping) of ``deg`` vs clean ``ref``."""
    return _score(ref, deg, fs, "wb")


def pesq_nb(ref, deg, fs: int = 8000) -> float:
    """Narrowband PESQ MOS-LQO (P.862.1 mapping). Inputs at any rate are
    resampled to 8 kHz; the IRS receive filter is approximated by a
    300-3400 Hz band-pass (see the module docstring's conformance caveat)."""
    return _score(ref, deg, fs, "nb")
