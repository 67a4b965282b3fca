"""End-to-end batched enhancement: noisy waveforms in, enhanced waveforms
out (port of ``dvae_tpu.enhance.pipeline``).

  device (one batch):
      PCM16 wire decode -> STFT (matmul DFT) -> |X|^2 -> encoder mean ->
      MCEM (chain kernel + NMF M-steps) -> Wiener masks -> S_hat = WFs*X
      -> batched mask-normalized ISTFT -> (B, T) waveforms
  host:
      ragged padding to 64-frame buckets, frame masks, per-utterance length
      finalisation and the Wiener-partition noise estimate N_hat = X - S_hat

CUDA work is asynchronous, so :meth:`Enhancer.dispatch` returns once the
batch is enqueued and :meth:`Enhancer.collect` blocks on the copy back.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np
import torch

from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.enhance.mcem import McemConfig, fold_seed, run_mcem
from dvae_tpu_torch.enhance.mh_chain import extract_decoder_mlp
from dvae_tpu_torch.ops.stft import (
    StftConfig,
    istft_realimag_masked,
    n_stft_frames_clamped,
    samples_for_frames,
    stft_realimag,
)

_LATER = "not served by this port yet (a later PR, ROADMAP queue A{})"


def _slice(seq, a, b):
    return None if seq is None else seq[a:b]


def _quantize_pcm16(x: torch.Tensor):
    """Per-utterance symmetric PCM16 quantization: (B, T) f32 -> (int16,
    scale). One formula for both wire directions (host inputs go through it
    as CPU tensors)."""
    peak = x.abs().amax(-1).clamp_min(1e-9)
    scale = (peak / 32767.0).to(torch.float32)
    q = torch.round(x / scale[:, None]).clamp(-32768, 32767).to(torch.int16)
    return q, scale


@dataclasses.dataclass(frozen=True)
class EnhancerConfig:
    """Same fields as the JAX package's config. This port serves
    ``y_mode="none"``, ``engine="mcem"``, ``ablation="none"``, ``norm=None``
    and ``aot_dir=None``; other values raise NotImplementedError."""

    stft: StftConfig = StftConfig()
    mcem: McemConfig = McemConfig()
    y_mode: str = "none"
    frame_bucket: int = 64      # frame counts rounded up to a multiple of this
    wire_dtype: str = "int16"   # "int16": PCM16 + per-utterance scale; "float32"
    # N_hat = X - S_hat on the host (exact by the Wiener partition) instead
    # of a second device ISTFT
    noise_from_partition: bool = True
    max_device_batch: int = 32  # larger requests are split into sub-batches
    pipeline_depth: int = 2     # enhance_stream: batches in flight before a collect
    ablation: str = "none"
    norm: tuple | None = None
    norm_eps: float = 1e-8
    engine: str = "mcem"
    aot_dir: str | None = None


class Enhancer:
    """Binds an M1 :class:`~dvae_tpu_torch.models.VAE` to the enhancement
    program on ``device`` (CUDA unless ``device="cpu"`` is passed)."""

    def __init__(self, model, cfg: EnhancerConfig = EnhancerConfig(), mesh=None,
                 device=None):
        if cfg.y_mode not in ("none", "enc_dec", "dec_only"):
            raise ValueError(f"bad y_mode {cfg.y_mode!r}")
        if cfg.wire_dtype not in ("int16", "float32"):
            raise ValueError(f"bad wire_dtype {cfg.wire_dtype!r}")
        if cfg.ablation not in ("none", "clean_z", "clean_z_nomcem"):
            raise ValueError(f"bad ablation {cfg.ablation!r}")
        if cfg.engine not in ("mcem", "peem", "peem-wf", "pmcem"):
            raise ValueError(f"bad engine {cfg.engine!r}")
        for name, value, served, item in (
                ("y_mode", cfg.y_mode, "none", 9), ("engine", cfg.engine, "mcem", 10),
                ("ablation", cfg.ablation, "none", 10), ("norm", cfg.norm, None, 8),
                ("aot_dir", cfg.aot_dir, None, 11), ("mesh", mesh, None, 14)):
            if value != served:
                raise NotImplementedError(f"{name}={value!r}: " + _LATER.format(item))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mats = extract_decoder_mlp(self.model, self.model.z_dim)
        if self.mats is None:
            raise NotImplementedError(
                "the MCEM chain needs a two-hidden-layer decoder; "
                + _LATER.format(10))
        self.last_cost = None

    def reload(self, state_dict) -> None:
        """Swap in same-shape weights (e.g. a newer checkpoint of the same
        model). Raises ValueError on any name/shape/dtype mismatch."""
        old = self.model.state_dict()
        if set(state_dict) != set(old):
            raise ValueError(f"state_dict keys differ: {sorted(set(state_dict) ^ set(old))[:6]}")
        for k, v in state_dict.items():
            if tuple(v.shape) != tuple(old[k].shape) or v.dtype != old[k].dtype:
                raise ValueError(f"param {k}: {tuple(v.shape)}/{v.dtype} != "
                                 f"{tuple(old[k].shape)}/{old[k].dtype}")
        self.model.load_state_dict(state_dict, strict=True)
        self.mats = extract_decoder_mlp(self.model, self.model.z_dim)

    # -- device program ------------------------------------------------------
    @torch.inference_mode()
    def _core(self, xw, x_scale, mask, seed: int, n_frames: int):
        cfg = self.cfg
        x = xw.to(torch.float32) * x_scale[:, None]
        re, im = stft_realimag(x, cfg.stft)
        re, im = re[:, :n_frames], im[:, :n_frames]  # (B, N, F)
        x2 = re * re + im * im
        _, z0, _ = self.model.encode(x2, sample=False)
        res = run_mcem(self.mats, x2, z0, mask, seed, cfg.mcem)
        s = istft_realimag_masked(res.wfs * re, res.wfs * im, mask, cfg.stft)
        n = None
        if not cfg.noise_from_partition:
            n = istft_realimag_masked(res.wfn * re, res.wfn * im, mask, cfg.stft)
        if cfg.wire_dtype == "int16":
            s, s_scale = _quantize_pcm16(s)
            if n is not None:
                n, n_scale = _quantize_pcm16(n)
        else:
            s_scale = n_scale = torch.ones((s.shape[0],), device=s.device)
        if n is None:
            return s, s_scale, res.cost
        return s, s_scale, n, n_scale, res.cost

    # -- host orchestration ----------------------------------------------------
    def _prepare(self, wavs, max_frames):
        """Pad/bucket the wavs into the wire arrays. Returns (xw, x_scale,
        mask, n_pad, frames) as CPU tensors / ints."""
        cfg = self.cfg
        b = len(wavs)
        frames = [n_stft_frames_clamped(len(w), cfg.stft) for w in wavs]
        if max_frames is not None:
            frames = [max(1, min(f, int(mf))) for f, mf in zip(frames, max_frames)]
        n_pad = -(-max(frames) // cfg.frame_bucket) * cfg.frame_bucket
        t_pad = samples_for_frames(n_pad, cfg.stft)
        x = np.zeros((b, t_pad), dtype=np.float32)
        for i, w in enumerate(wavs):
            t_use = min(len(w), t_pad)  # max_frames may leave samples unused
            x[i, :t_use] = np.asarray(w[:t_use], dtype=np.float32)
        x = torch.from_numpy(x)
        if cfg.wire_dtype == "int16":
            xw, x_scale = _quantize_pcm16(x)
        else:
            xw, x_scale = x, torch.ones((b,))
        mask = torch.zeros((b, n_pad))
        for i in range(b):
            mask[i, :frames[i]] = 1.0
        return xw, x_scale, mask, n_pad, frames

    def _dispatch(self, wavs, seed, max_frames):
        """Pad + upload one batch and enqueue its device work (async)."""
        xw, x_scale, mask, n_pad, frames = self._prepare(wavs, max_frames)
        dev = self.device
        out_dev = self._core(xw.to(dev), x_scale.to(dev), mask.to(dev),
                             0 if seed is None else seed, n_pad)
        lengths = [len(w) for w in wavs]
        if self.cfg.noise_from_partition:
            cover = [samples_for_frames(fi, self.cfg.stft) for fi in frames]
            return out_dev, (lengths, [np.asarray(w, np.float32) for w in wavs], cover)
        return out_dev, lengths

    def _collect(self, handle) -> list[tuple[np.ndarray, np.ndarray]]:
        """Pull a dispatched batch back to the host and finalize lengths."""
        if self.cfg.noise_from_partition:
            (s_dev, s_sc, cost), (lengths, xs, cover) = handle
        else:
            (s_dev, s_sc, n_dev, n_sc, cost), lengths = handle
            n_all = n_dev.cpu().numpy().astype(np.float32) * n_sc.cpu().numpy()[:, None]
        s_all = s_dev.cpu().numpy().astype(np.float32) * s_sc.cpu().numpy()[:, None]
        out = []
        for i, t_i in enumerate(lengths):
            s = np.zeros(t_i, np.float32)
            t_have = min(t_i, s_all.shape[-1])
            s[:t_have] = s_all[i, :t_have]
            if self.cfg.noise_from_partition:
                # Wiener partition: N_hat = X - S_hat on covered samples, zero
                # beyond the frames' coverage
                n = xs[i][:t_i] - s
                n[min(cover[i], t_i):] = 0.0
                s[min(cover[i], t_i):] = 0.0
            else:
                n = np.zeros(t_i, np.float32)
                n[:t_have] = n_all[i, :t_have]
            out.append((s, n))
        self.last_cost = cost.cpu().numpy()
        return out

    def enhance_batch(self, wavs: Sequence[np.ndarray], seed: int | None = None,
                      max_frames: Sequence[int] | None = None):
        """Enhance a batch of (possibly ragged) utterances.

        Args:
            wavs: float waveforms at ``cfg.stft.fs``.
            seed: integer seed of the MCEM random streams (default 0).
            max_frames: optional per-utterance frame cap.
        Returns:
            list of (s_hat, n_hat) float32 waveforms, each ``len(wavs[i])``.
        """
        return self.collect(self.dispatch(wavs, seed, max_frames))

    def dispatch(self, wavs, seed: int | None = None, max_frames=None) -> list:
        """The asynchronous half of :meth:`enhance_batch`: enqueue the work
        (split at ``max_device_batch``) and return a handle for
        :meth:`collect`."""
        mdb = self.cfg.max_device_batch
        if len(wavs) == 0:
            return []
        if len(wavs) <= mdb:
            return [self._dispatch(wavs, seed, max_frames)]
        seed = 0 if seed is None else seed
        return [self._dispatch(wavs[a:a + mdb], fold_seed(seed, j),
                               _slice(max_frames, a, a + mdb))
                for j, a in enumerate(range(0, len(wavs), mdb))]

    def collect(self, handles: list) -> list[tuple[np.ndarray, np.ndarray]]:
        """Block on a :meth:`dispatch` handle; returns ``[(s_hat, n_hat)]``."""
        out = []
        for h in handles:
            out.extend(self._collect(h))
        return out

    def enhance_stream(self, batches, seed: int | None = None):
        """Pipelined enhancement over an iterable of ``(wavs, ys, max_frames)``
        batches (``ys`` must be None in this port). Up to
        ``pipeline_depth + 1`` batches are in flight; yields one result list
        per input batch, in order."""
        seed = 0 if seed is None else seed
        mdb = self.cfg.max_device_batch
        depth = max(1, self.cfg.pipeline_depth)

        def sub_batches():
            for i, tup in enumerate(batches):
                wavs, ys, max_frames = tup[:3]
                if ys is not None or len(tup) > 3:
                    raise NotImplementedError("labels / clean wavs: " + _LATER.format(9))
                if len(wavs) == 0:
                    yield i, 0, True, None, None  # keeps one yield per batch
                    continue
                for j, a in enumerate(range(0, len(wavs), mdb)):
                    yield (i, j, a + mdb >= len(wavs), wavs[a:a + mdb],
                           _slice(max_frames, a, a + mdb))

        acc = []
        pending = collections.deque()  # (handle_or_None, last)

        def emit(handle, last):
            nonlocal acc
            if handle is not None:
                acc.extend(self._collect(handle))
            if last:
                out, acc = acc, []
                return out
            return None

        for i, j, last, wavs, max_frames in sub_batches():
            handle = None if wavs is None else self._dispatch(
                wavs, fold_seed(fold_seed(seed, i), j), max_frames)
            pending.append((handle, last))
            if len(pending) > depth:
                out = emit(*pending.popleft())
                if out is not None:
                    yield out
        while pending:
            out = emit(*pending.popleft())
            if out is not None:
                yield out
