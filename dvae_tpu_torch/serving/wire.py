"""Wire-format helpers of the serving package (port of
``dvae_tpu.serving.wire``): RIFF/WAVE encode and decode, incremental PCM
parsing for the full-duplex path, and the sample-block feed accumulation
contract. Pure bytes/arrays in, bytes/arrays out."""

from __future__ import annotations

import io as _io
import struct

import numpy as np

from dvae_tpu_torch.data.io import pcm16, read_wav, write_wav


def _wav_bytes(channels: list[np.ndarray], fs: int) -> bytes:
    """Float waveform(s) -> in-memory 16-bit PCM RIFF through
    ``data.io.write_wav``, the one PCM quantization."""
    x = channels[0] if len(channels) == 1 else np.stack(channels, axis=-1)
    buf = _io.BytesIO()
    write_wav(buf, x, fs)
    return buf.getvalue()


def _riff_header(data_bytes: int, n_channels: int, fs: int) -> bytes:
    """The 44-byte PCM16 RIFF/WAVE header (the layout scipy writes) with the
    final sizes: a streamed response knows its exact length up front (input
    samples at the model rate)."""
    return (b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, n_channels, fs,
                                    fs * 2 * n_channels, 2 * n_channels, 16)
            + b"data" + struct.pack("<I", data_bytes))


def _pcm_seg_bytes(seg: tuple[np.ndarray, np.ndarray], want: str) -> bytes:
    """One streamed (s_seg, n_seg) pair -> wire PCM16 bytes (stereo
    interleaves speech/noise per frame, like the one-shot response)."""
    s, n = seg
    if want == "speech":
        x = pcm16(s)
    elif want == "noise":
        x = pcm16(n)
    else:
        x = np.stack([pcm16(s), pcm16(n)], axis=-1)
    return x.astype("<i2").tobytes()


def _parse_wav_bytes(body: bytes) -> tuple[np.ndarray, int]:
    """RIFF bytes -> (float64 mono samples in [-1, 1), rate) through
    ``data.io.read_wav``; multi-channel inputs are downmixed by mean."""
    data, fs = read_wav(_io.BytesIO(body))
    if data.ndim > 1:
        data = data.mean(axis=-1)
    return data, int(fs)


def _feed_into(blocks, buf: np.ndarray, n_samples: int, on_progress=None) -> None:
    """Accumulate a sample-block feed into ``buf`` left to right (float32
    ravel, clamped past n_samples), calling ``on_progress(got)`` after each
    block; raises ValueError if the feed ends before ``n_samples``."""
    got = 0
    for blk in blocks:
        blk = np.asarray(blk, np.float32).ravel()
        take = min(len(blk), n_samples - got)
        buf[got:got + take] = blk[:take]
        got += take
        if on_progress is not None:
            on_progress(got)
        if got >= n_samples:
            return
    raise ValueError(f"request body ended early: got {got} of {n_samples} samples")


def _collect_feed(blocks, n_samples: int) -> np.ndarray:
    """Gather a sample-block feed into one float32 buffer (a single device
    item needs the whole signal before admission)."""
    buf = np.zeros(n_samples, np.float32)
    _feed_into(blocks, buf, n_samples)
    return buf


# PCM encodings the duplex path decodes incrementally, as (format_code,
# bits_per_sample): 1 = integer PCM, 3 = IEEE float. Others fall back to the
# buffered scipy parser.
_STREAMABLE_PCM = {(1, 8), (1, 16), (1, 32), (3, 32), (3, 64)}


def _riff_stream_info(rfile, remaining: int):
    """Incrementally parse a RIFF prefix up to the start of the 'data'
    payload, reading nothing beyond it.

    Returns ``(consumed, info)``: ``consumed`` is every byte read (a caller
    that does not stream reassembles the body as ``consumed + rest``) and
    ``info`` is None when the prefix is not incrementally decodable PCM,
    else a dict of ``fmt``/``bits``/``channels``/``fs``/``data_bytes``.
    ``data_bytes`` is bounded by the data chunk's size and the request's
    remaining Content-Length (writers that emit wavs as they record leave
    the sizes 0 or 0xFFFFFFFF, which resolves to the HTTP length)."""
    out = bytearray()

    def take(n: int) -> bytes:
        nonlocal remaining
        n = min(n, remaining)
        raw = rfile.read(n) if n > 0 else b""
        out.extend(raw)
        remaining -= len(raw)
        if len(raw) < n:
            raise EOFError
        return raw

    try:
        head = take(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            return bytes(out), None
        fmt = None
        while True:
            cid, size = struct.unpack("<4sI", take(8))
            if cid == b"fmt ":
                body = take(size + (size & 1))
                fmt_code, channels, fs = struct.unpack("<HHI", body[:8])
                bits = struct.unpack("<H", body[14:16])[0]
                if fmt_code == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                    fmt_code = struct.unpack("<H", body[24:26])[0]
                fmt = (fmt_code, channels, fs, bits)
            elif cid == b"data":
                if fmt is None:
                    return bytes(out), None
                fmt_code, channels, fs, bits = fmt
                if (fmt_code, bits) not in _STREAMABLE_PCM or channels < 1:
                    return bytes(out), None
                data_bytes = size if 0 < size < 0xFFFFFFFF else remaining
                return bytes(out), {
                    "fmt": fmt_code, "bits": bits, "channels": channels,
                    "fs": int(fs), "data_bytes": min(data_bytes, remaining)}
            else:  # LIST/fact/JUNK/...: buffer and move on (word-aligned)
                take(size + (size & 1))
    except (EOFError, struct.error):
        return bytes(out), None


def _pcm_to_float_mono(raw: bytes, fmt_code: int, bits: int, channels: int) -> np.ndarray:
    """Decode whole PCM frames exactly as the buffered path does
    (``read_wav`` + channel downmix + float32 cast): integer PCM scales by
    1/2**(bits-1) in float64, uint8 offsets by 128, multi-channel
    downmixes by mean, then casts to float32."""
    if fmt_code == 3:
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float64)
    elif bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float64) / 32768.0
    elif bits == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float64) / 2147483648.0
    else:  # (1, 8): unsigned with a 128 offset, as scipy reads it
        x = (np.frombuffer(raw, np.uint8).astype(np.float64) - 128.0) / 128.0
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=-1)
    return x.astype(np.float32)
