"""Plain signal processing of the enhancement path: the reference frontend's
frame counts, the PCM16 wire, the STFT power and the masked ISTFT, with
``torch.fft`` instead of the program's matmul DFT."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import Precision, round_bits


class Stft:
    """The STFT settings of a configuration (the reference's production
    defaults: 16 kHz, a 64 ms periodic Hann window, a hop of a quarter)."""

    def __init__(self, fs: int = 16000, wlen_sec: float = 64e-3, hop_percent: float = 0.25):
        self.fs, self.wlen_sec, self.hop_percent = fs, wlen_sec, hop_percent
        self.nfft = int(wlen_sec * fs)
        self.hop = int(hop_percent * self.nfft)
        self.bins = self.nfft // 2 + 1

    def frames(self, n_samples: int) -> int:
        """Frames of a signal of ``n_samples`` (at least 1): the reference
        pads ``hop`` zeros at the end unless ``len / fs / wlen_sec /
        hop_percent`` is an exact float integer."""
        q = n_samples / self.fs / self.wlen_sec / self.hop_percent
        t = n_samples + (self.hop if math.ceil(q) != int(q) else 0)
        return max(1, 1 + (t - self.nfft) // self.hop)

    def samples(self, n_frames: int) -> int:
        """Samples ``n_frames`` frames cover."""
        return (n_frames - 1) * self.hop + self.nfft

    def window(self, device) -> torch.Tensor:
        n = np.arange(self.nfft)
        return torch.from_numpy((0.5 - 0.5 * np.cos(2 * np.pi * n / self.nfft))
                                .astype(np.float32)).to(device)


def pcm16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric PCM16: (B, T) -> (int16 values as f32, scale):
    scale = max(peak, 1e-9) / 32767, values rounded to nearest even."""
    peak = x.abs().amax(-1).clamp_min(1e-9)
    scale = (peak / 32767.0).float()
    return torch.round(x / scale[:, None]).clamp(-32768, 32767), scale


def pack(wavs, st: Stft, bucket: int, device):
    """The padded batch of the enhancement path: (B, T_pad) f32 signals,
    per-utterance frame counts and the padded frame count (the longest
    rounded up to ``bucket``)."""
    frames = [st.frames(len(w)) for w in wavs]
    n_pad = -(-max(frames) // bucket) * bucket
    t_pad = st.samples(n_pad)
    x = np.zeros((len(wavs), t_pad), np.float32)
    for i, w in enumerate(wavs):
        x[i, :min(len(w), t_pad)] = w[:t_pad]
    return torch.from_numpy(x).to(device), frames, n_pad


def stft(x: torch.Tensor, st: Stft, n_frames: int, prec: Precision):
    """(re, im) of the first ``n_frames`` frames of (B, T) signals."""
    fr = x.unfold(-1, st.nfft, st.hop)[:, :n_frames] * st.window(x.device)
    spec = torch.fft.rfft(round_bits(fr, prec.mm), dim=-1)
    return spec.real.float(), spec.imag.float()


def power(x: torch.Tensor, st: Stft, n_frames: int, prec: Precision) -> torch.Tensor:
    re, im = stft(x, st, n_frames, prec)
    return re * re + im * im


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    b, n, nfft = frames.shape
    out = frames.new_zeros((b, (n - 1) * hop + nfft))
    for i in range(n):
        out[:, i * hop:i * hop + nfft] += frames[:, i]
    return out


def istft_masked(re, im, mask, st: Stft, prec: Precision) -> torch.Tensor:
    """Windowed overlap-add ISTFT of a padded batch: each sample divided by
    the overlap-add of the squared window over the valid frames (where that
    exceeds float32's tiny)."""
    spec = torch.complex(round_bits(re, prec.mm), round_bits(im, prec.mm))
    frames = torch.fft.irfft(spec, n=st.nfft, dim=-1)
    win = st.window(re.device)
    m = mask.float()[..., None]
    x = _overlap_add(frames * win * m, st.hop)
    wss = _overlap_add((win * win).expand(frames.shape) * m, st.hop)
    tiny = float(np.finfo(np.float32).tiny)
    return torch.where(wss > tiny, x / wss.clamp_min(1e-37), x)


def finalize(s_q, scale, wavs, frames, st: Stft):
    """Per utterance (s_hat, n_hat) as the wire returns them: the PCM16
    values times their scale, cut to the input's length; the noise is the
    Wiener partition x - s_hat; both zero past the frames' coverage."""
    s_all = s_q.cpu().numpy().astype(np.float32) * scale.cpu().numpy()[:, None]
    out = []
    for i, w in enumerate(wavs):
        n = len(w)
        s = np.zeros(n, np.float32)
        have = min(n, s_all.shape[-1])
        s[:have] = s_all[i, :have]
        cover = min(st.samples(frames[i]), n)
        noise = np.asarray(w, np.float32)[:n] - s
        noise[cover:] = 0.0
        s[cover:] = 0.0
        out.append((s, noise))
    return out
