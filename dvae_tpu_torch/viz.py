"""Figure generation for the analysis CLIs (port of ``dvae_tpu.viz``):
reconstruct_*, run_metrics, run_metrics_classif.

Capability parity with the reference's packages/visualization.py
(waveplots, dB spectrograms with a VAD-row broadcast trick,
wave+spectrogram+mask grids), on plain matplotlib. ``matplotlib`` (and
``cv2`` for :func:`write_vad_demo_video`) is imported inside the functions
that draw, so that importing this module needs neither; the CLIs call
:func:`require_matplotlib` / :func:`require_cv2` before any device work.
Unless a backend was chosen before, the first figure picks the headless Agg
backend; callers ``savefig``.
"""

from __future__ import annotations

import numpy as np


def require_matplotlib(what: str = "figures") -> None:
    """Exit, naming the package, where ``matplotlib`` does not import."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        raise SystemExit(f"{what} need matplotlib, which this machine lacks") from None


def require_cv2(what: str = "videos") -> None:
    """Exit, naming the package, where ``cv2`` (opencv) does not import."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise SystemExit(f"{what} need opencv (cv2), which this machine lacks") from None


def _plt():
    """``matplotlib.pyplot``, with Agg as a headless DEFAULT, not an
    override: picked only when no backend was explicitly selected
    (run_metrics* select 'pdf' first and keep it; the sentinel marks
    matplotlib's unresolved auto-selection state)."""
    import matplotlib

    try:
        unset = dict.__getitem__(matplotlib.rcParams, "backend") is \
            matplotlib.rcsetup._auto_backend_sentinel
    except AttributeError:  # the sentinel is private API: fall back to overriding
        unset = True
    if unset:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _spec_db(spec_or_power, power: bool, eps: float = 1e-12) -> np.ndarray:
    a = np.asarray(spec_or_power)
    if np.iscomplexobj(a):
        a = np.abs(a) ** 2
        power = True
    return 10.0 * np.log10(a + eps) if power else 20.0 * np.log10(np.abs(a) + eps)


def _imshow_spec(ax, db, fs, hop_sec, vmin=-60, vmax=10, cmap="magma"):
    """db: (n_frames, n_bins) -> time-x, freq-y image."""
    n_frames = db.shape[0]
    im = ax.imshow(
        db.T,
        origin="lower",
        aspect="auto",
        extent=[0, n_frames * hop_sec, 0, fs / 2000.0],
        vmin=vmin,
        vmax=vmax,
        cmap=cmap,
    )
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Frequency (kHz)")
    return im


def display_waveplot(x, fs=16000, ax=None):
    """Time-domain waveform plot (visualization.py:8-42)."""
    ax = ax or _plt().gca()
    t = np.arange(len(x)) / fs
    ax.plot(t, np.asarray(x), linewidth=0.5)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Amplitude")
    ax.set_xlim(0, t[-1] if len(t) else 1)
    return ax


def display_spectrogram(complex_spec, fs=16000, wlen_sec=64e-3, hop_percent=0.25,
                        vmin=-60, vmax=10, ax=None, vad=None):
    """Power-dB spectrogram of a complex (n_frames, n_bins) STFT
    (visualization.py:44-105). ``vad``: optional per-frame labels overlaid
    via the reference's row-broadcast trick (visualization.py:73-75 — the
    (frames,) VAD tiled across all bins, drawn translucently on top)."""
    ax = ax or _plt().gca()
    hop_sec = wlen_sec * hop_percent
    im = _imshow_spec(ax, _spec_db(complex_spec, power=True), fs, hop_sec, vmin, vmax)
    if vad is not None:
        n_bins = np.asarray(complex_spec).shape[-1]
        m = vad_as_mask(vad, n_bins)
        # fixed 0..1 limits like the reference (visualization.py passes
        # vmin=0, vmax=1 for masks): without them a UNIFORM mask (the
        # ones/zeros conditioning probes) autoscales to colormap 0 and an
        # all-ones overlay renders identically to all-zeros
        ax.imshow(np.asarray(m).T, origin="lower", aspect="auto", alpha=0.25,
                  vmin=0.0, vmax=1.0,
                  extent=[0, m.shape[0] * hop_sec, 0, fs / 2000.0], cmap="gray")
    _plt().colorbar(im, ax=ax)
    return ax


def display_power_spectro(psd, fs=16000, wlen_sec=64e-3, hop_percent=0.25,
                          vmin=-60, vmax=10, ax=None):
    """dB image of a (n_frames, n_bins) power spectrogram
    (visualization.py:107-155)."""
    ax = ax or _plt().gca()
    hop_sec = wlen_sec * hop_percent
    im = _imshow_spec(ax, _spec_db(psd, power=True), fs, hop_sec, vmin, vmax)
    _plt().colorbar(im, ax=ax)
    return ax


def vad_as_mask(vad, n_bins: int = 513) -> np.ndarray:
    """Broadcast a (n_frames,) VAD row to a (n_frames, n_bins) mask — the
    reference's display trick (visualization.py:73-75)."""
    vad = np.asarray(vad).reshape(-1)
    return np.repeat(vad[:, None], n_bins, axis=1)


def display_wav_spectro_mask(x, spec, mask, fs=16000, wlen_sec=64e-3,
                             hop_percent=0.25, fig=None):
    """Column of waveform / spectrogram / mask (visualization.py:157-199)."""
    fig = fig or _plt().figure(figsize=(12, 10))
    axes = fig.subplots(3, 1)
    display_waveplot(x, fs, ax=axes[0])
    hop_sec = wlen_sec * hop_percent
    # real-valued inputs here are MAGNITUDE spectra (reconstruct passes
    # sqrt(variance)); the reference renders them with amplitude_to_db
    # (20*log10), not the power convention
    _imshow_spec(axes[1], _spec_db(spec, power=False), fs, hop_sec)
    if mask.ndim == 1 or mask.shape[-1] == 1:
        # spec is required here (already rendered above) — unlike
        # display_multiple_signals, whose rows accept (None, None, mask)
        mask = vad_as_mask(mask, np.asarray(spec).shape[-1])
    axes[2].imshow(np.asarray(mask).T, origin="lower", aspect="auto",
                   vmin=0.0, vmax=1.0,  # absolute mask scale (see above)
                   extent=[0, mask.shape[0] * hop_sec, 0, fs / 2000.0], cmap="gray")
    axes[2].set_xlabel("Time (s)")
    axes[2].set_ylabel("Frequency (kHz)")
    return fig


def display_multiple_signals(signal_list, fs=16000, wlen_sec=64e-3,
                             hop_percent=0.25, vmin=-60, vmax=10, fig=None):
    """Grid: one column per signal, rows = (wave, spectrogram, mask)
    (visualization.py:201-269). Each item: (x, spec, mask-or-None).
    ``vmin``/``vmax`` are the dB color limits (the reconstruct scripts pass
    the reference's -40/20, reconstruct_M1.py:74-75)."""
    n = len(signal_list)
    fig = fig or _plt().figure(figsize=(8 * n, 12))
    axes = fig.subplots(3, n, squeeze=False)
    hop_sec = wlen_sec * hop_percent
    for j, (x, spec, mask) in enumerate(signal_list):
        if x is not None:
            display_waveplot(x, fs, ax=axes[0][j])
        if spec is not None:
            # amplitude convention for real inputs (see display_wav_spectro_mask)
            _imshow_spec(axes[1][j], _spec_db(spec, power=False), fs, hop_sec,
                         vmin, vmax)
        if mask is not None:
            m = np.asarray(mask)
            if m.ndim == 1 or m.shape[-1] == 1:
                # the reference broadcasts to its hard-coded 513 bins when no
                # spectrogram accompanies the mask (visualization.py:73-75)
                n_bins = np.asarray(spec).shape[-1] if spec is not None else 513
                m = vad_as_mask(m, n_bins)
            axes[2][j].imshow(m.T, origin="lower", aspect="auto",
                              vmin=0.0, vmax=1.0,  # absolute mask scale
                              extent=[0, m.shape[0] * hop_sec, 0, fs / 2000.0],
                              cmap="gray")
    return fig


def display_multiple_spectro(spec_list, fs=16000, wlen_sec=64e-3,
                             hop_percent=0.25, vmin=-60, vmax=10, fig=None):
    """Row of spectrograms (visualization.py:271-326)."""
    n = len(spec_list)
    fig = fig or _plt().figure(figsize=(8 * n, 5))
    axes = fig.subplots(1, n, squeeze=False)[0]
    hop_sec = wlen_sec * hop_percent
    for j, spec in enumerate(spec_list):
        _imshow_spec(axes[j], _spec_db(spec, power=True), fs, hop_sec, vmin, vmax)
    return fig


def write_vad_demo_video(frames, vad, out_path, fps: float = 62.5,
                         audio_wav: str | None = None) -> str:
    """Lip-video VAD demo: white bottom-right square on active frames.

    The reference carries this as a commented (and unrunnable — ``x_video``
    is never defined there) experiment in run_metrics_classif.py:238-294:
    write the upsampled 67x67 lip frames with ``frame[-9:, -9:] = 255`` on
    frames where the label is 1, then mux the clean audio in. This is the
    working version; soft labels scale the square's intensity (completing
    the "#TODO: make video with y_hat_soft" at its :296).

    Args:
        frames: (H, W, n_frames) array, pixel range 0..255 (the builders'
            ``<utt>_upsampled.h5`` ``X`` layout).
        vad: per-frame label values in [0, 1]; length is reconciled with
            the frame count by truncation (the reference trims audio/video
            streams to their common length everywhere).
        out_path: output video path (.mp4, mp4v).
        fps: output frame rate — 62.5 = 1/(wlen_sec*hop_percent), the
            builders' upsampled rate (create_video_train_files.py:57-58).
        audio_wav: when given AND an ``ffmpeg`` binary is on PATH, the audio
            is muxed into ``out_path`` (aac) like the reference's
            ffmpeg-python calls; without ffmpeg the video is written silent
            under the same name (cv2 cannot mux audio).
    Returns the written path.
    """
    import shutil
    import subprocess
    import tempfile

    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("write_vad_demo_video needs opencv (cv2)") from e

    frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError(f"frames must be (H, W, n), got {frames.shape}")
    v = np.asarray(vad, np.float32).reshape(-1)
    n = min(frames.shape[-1], len(v))
    h, w = frames.shape[:2]

    mux = audio_wav is not None and shutil.which("ffmpeg") is not None
    tmp = None
    if mux:
        tmp = tempfile.NamedTemporaryFile(suffix=".mp4", delete=False)
        tmp.close()
    video_path = tmp.name if mux else str(out_path)
    writer = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h), False)
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {video_path}")
    try:
        for j in range(n):
            f = np.clip(frames[..., j], 0, 255).astype(np.uint8).copy()
            if v[j] > 0:
                # reference overlay: x_video_frame.T[-9:,-9:] = 255 on the
                # transposed frame, written back transposed == the stored
                # frame's own bottom-right corner (run_metrics_classif.py:254)
                f[-9:, -9:] = int(round(255 * min(float(v[j]), 1.0)))
            writer.write(f)
    finally:
        writer.release()
    if mux:
        import os

        try:
            subprocess.run(
                ["ffmpeg", "-y", "-i", video_path, "-i", str(audio_wav),
                 "-c:v", "copy", "-c:a", "aac", "-strict", "experimental",
                 str(out_path)],
                check=True, capture_output=True)
        finally:
            os.unlink(video_path)
    return str(out_path)
