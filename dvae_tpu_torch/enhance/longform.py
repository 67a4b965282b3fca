"""Bounded-memory enhancement of arbitrarily long audio (port of
``dvae_tpu.enhance.longform``).

The E-step engines are length-agnostic, but device memory grows linearly
with frames: the chain keeps |X|^2, the NMF planes and the emitted Vs
samples resident. :func:`enhance_chunked` bounds memory by constants that
do not depend on the input:

* the waveform splits into hop-aligned chunks of ``chunk_seconds`` with a
  short ``overlap_seconds`` cross-fade region (at most half a chunk: the
  complementary fades assume two-deep coverage);
* chunks dispatch in groups of ``max_concurrent_chunks`` through
  :meth:`Enhancer.enhance_stream`, which keeps ``pipeline_depth`` groups in
  flight, so resident memory is depth x group x chunk whatever the file
  length;
* overlaps cross-fade in the time domain with complementary raised-cosine
  ramps that sum to exactly 1, so the Wiener partition survives: each
  chunk's ``s + n`` reconstructs its mixture span, and a convex blend of
  two reconstructions of the same span is still that span.

Per-chunk MCEM re-fits the NMF noise model (W, H, g) from scratch.

Labels: chunk boundaries are multiples of the STFT hop, so frame ``k`` of
the chunk starting at sample ``a`` is global frame ``a/hop + k``; a
full-length label array slices per chunk by that offset (the boundary
frame whose window straddles the cut replicates the last available row).
Self-labeling models pass ``labeler`` instead (called once per dispatch
group with that group's chunks, e.g. ``labeling.self_soft_labels``).

Pure numpy apart from the :class:`Enhancer` it drives.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

from dvae_tpu_torch.ops.stft import n_stft_frames_clamped


def chunk_spans(n_samples: int, fs: int, hop: int, chunk_seconds: float,
                overlap_seconds: float) -> list[tuple[int, int]]:
    """Hop-aligned [start, end) spans covering [0, n_samples).

    Every span has the same length (``chunk``) when the signal is longer
    than one chunk: the final span slides back to ``[n - chunk, n]``
    instead of ending short, so all chunk items land in one frame bucket
    (its extra overlap with its predecessor is handled by
    :func:`overlap_add`'s weight normalization). Interior overlap is
    ``overlap_seconds`` rounded to whole hops."""
    if n_samples <= 0:
        raise ValueError("empty signal")
    chunk = max(hop, int(round(chunk_seconds * fs / hop)) * hop)
    ov = int(round(overlap_seconds * fs / hop)) * hop
    # at most two chunks may cover any sample (the cross-fades are
    # pairwise): overlap may not exceed half the chunk (ov <= step)
    if ov < 0 or 2 * ov > chunk:
        raise ValueError(
            f"overlap {overlap_seconds}s must be at most half the chunk "
            f"{chunk_seconds}s (got {ov} vs chunk {chunk} samples)")
    if n_samples <= chunk:
        return [(0, n_samples)]
    step = chunk - ov
    spans, a = [], 0
    while a + chunk < n_samples:
        spans.append((a, a + chunk))
        a += step
    # the final span is exactly chunk-length ending at n: its start is
    # hop-aligned only when n is, so label slicing rounds its frame offset
    # to the nearest frame; audio reassembly is sample-exact regardless
    spans.append((n_samples - chunk, n_samples))
    return spans


def _fade_in(ov: int) -> np.ndarray:
    """Raised-cosine ramp; paired as (ramp, 1-ramp) so overlaps sum to 1."""
    k = np.arange(ov, dtype=np.float64)
    return np.sin(0.5 * math.pi * (k + 0.5) / ov) ** 2


class StreamingOverlapAdd:
    """Incremental :func:`overlap_add`: feed pieces in span order, get back
    the newly finalized samples after each one.

    Spans have strictly increasing starts, so once piece ``i`` has been
    blended every sample before ``spans[i+1][0]`` is final and can leave
    the process (e.g. onto an HTTP socket) while later chunks are still on
    the device. The concatenation of the emitted segments is bitwise the
    one-shot :func:`overlap_add` result."""

    def __init__(self, spans: Sequence[tuple[int, int]], n_samples: int):
        self.spans = list(spans)
        self.n_samples = n_samples
        self._out = np.zeros(n_samples, np.float64)
        self._weight = np.zeros(n_samples, np.float64)
        self._next = 0       # index of the piece expected next
        self._emitted = 0    # samples already finalized

    def add(self, piece: np.ndarray) -> np.ndarray:
        """Blend the next span's output; return the newly final float32
        samples (possibly empty)."""
        i = self._next
        if i >= len(self.spans):
            raise ValueError("all spans already added")
        a, b = self.spans[i]
        piece = np.asarray(piece, np.float64)
        if piece.shape != (b - a,):
            raise ValueError(f"chunk {i}: got {piece.shape}, want {(b - a,)}")
        fade = np.ones(b - a, np.float64)
        if i > 0:
            ov = self.spans[i - 1][1] - a     # head overlap with predecessor
            if ov > 0:
                fade[:ov] = _fade_in(min(ov, b - a))[:ov]
        if i + 1 < len(self.spans):
            ov = b - self.spans[i + 1][0]     # tail overlap with successor
            if ov > 0:
                fade[-ov:] = (1.0 - _fade_in(min(ov, b - a)))[-ov:]
        self._out[a:b] += piece * fade
        self._weight[a:b] += fade
        self._next += 1
        final = (self.spans[i + 1][0] if self._next < len(self.spans)
                 else self.n_samples)
        final = max(final, self._emitted)
        seg_w = self._weight[self._emitted:final]
        if (seg_w <= 0).any():
            raise ValueError("uncovered or zero-weight samples in overlap_add")
        seg = (self._out[self._emitted:final] / seg_w).astype(np.float32)
        self._emitted = final
        return seg


def overlap_add(spans: Sequence[tuple[int, int]],
                pieces: Sequence[np.ndarray], n_samples: int) -> np.ndarray:
    """Cross-fade chunk outputs back into one signal: complementary
    raised-cosine pairs, explicitly weight-normalized (the final chunk's
    larger overlap can make a pair non-complementary), so every sample is a
    convex combination of the chunks covering it."""
    if len(pieces) != len(spans):
        raise ValueError(f"{len(pieces)} pieces for {len(spans)} spans")
    if not pieces:
        raise ValueError("uncovered or zero-weight samples in overlap_add")
    acc = StreamingOverlapAdd(spans, n_samples)
    return np.concatenate([acc.add(p) for p in pieces])


def enhance_chunked(enhancer, wav: np.ndarray, y: np.ndarray | None = None,
                    chunk_seconds: float = 60.0, overlap_seconds: float = 1.0,
                    seed: int | None = None, labeler: Callable | None = None,
                    max_concurrent_chunks: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """Enhance one long waveform in bounded device memory.

    Args:
        enhancer: an :class:`~dvae_tpu_torch.enhance.pipeline.Enhancer`.
        wav: float waveform at the enhancer's sample rate.
        y: full-length (n_frames, y_dim) labels for conditional models,
            sliced per chunk by hop offset.
        seed: integer seed of the engine's random streams; each dispatch
            group draws its own stream from it (``enhance_stream``).
        labeler: alternative to ``y``: called once per dispatch group with
            that group's chunk waveforms, returns per-chunk label arrays.
        max_concurrent_chunks: chunks per dispatch, the memory bound.
    Returns:
        (s_hat, n_hat) float32 waveforms of ``len(wav)``, whose sum
        reconstructs ``wav``.
    """
    if y is not None and labeler is not None:
        raise ValueError("pass y or labeler, not both")
    cfg = enhancer.cfg.stft
    wav = np.asarray(wav, np.float32)
    spans = chunk_spans(len(wav), cfg.fs, cfg.hop, chunk_seconds, overlap_seconds)
    wavs = [wav[a:b] for a, b in spans]
    ys = None
    if y is not None:
        y = np.asarray(y, np.float32)
        ys = []
        for (a, b), w in zip(spans, wavs):
            # nearest frame: every start is hop-aligned except possibly the
            # final full-length span, whose grid shifts by < half a frame
            off = (a + cfg.hop // 2) // cfg.hop
            n = n_stft_frames_clamped(len(w), cfg)
            yc = y[off:off + n]
            if len(yc) < n:            # boundary frame past the label tail
                if len(y) == 0:
                    raise ValueError("empty label array")
                yc = np.concatenate([yc, np.repeat(y[-1:], n - len(yc), axis=0)])
            ys.append(yc)
    if max_concurrent_chunks < 1:
        raise ValueError("max_concurrent_chunks must be >= 1")

    def groups():
        for g in range(0, len(wavs), max_concurrent_chunks):
            h = g + max_concurrent_chunks
            if labeler is not None:
                yg = list(labeler(wavs[g:h]))   # per group: a bounded batch
            else:
                yg = None if ys is None else ys[g:h]
            yield wavs[g:h], yg, None

    outs = []
    for out in enhancer.enhance_stream(groups(), seed=seed):
        outs.extend(out)
    s = overlap_add(spans, [o[0] for o in outs], len(wav))
    n = overlap_add(spans, [o[1] for o in outs], len(wav))
    return s, n
