"""End-to-end batched enhancement: noisy waveforms in, enhanced waveforms
out (port of ``dvae_tpu.enhance.pipeline``).

  device (one batch):
      PCM16 wire decode -> STFT (matmul DFT) -> |X|^2 -> encoder mean
      (of [|X|^2; y] for ``y_mode="enc_dec"``; of the clean spectrogram for
      the clean-z ablations) -> the E-step engine (MCEM and its variants:
      chain kernel with the labels folded into its row bias, NMF M-steps)
      -> Wiener masks -> S_hat = WFs*X -> batched mask-normalized ISTFT
      -> (B, T) waveforms
  host:
      ragged padding to 64-frame buckets, frame masks and zero-padded
      labels, per-utterance length finalisation and the Wiener-partition
      noise estimate N_hat = X - S_hat

CUDA work is asynchronous, so :meth:`Enhancer.dispatch` returns once the
batch is enqueued and :meth:`Enhancer.collect` blocks on the copy back.

On a :class:`~dvae_tpu_torch.parallel.Mesh` the padded batch (its
utterance count padded to a multiple of the mesh with 1-frame silent
utterances) is split into ``mesh.size`` contiguous shards, one dispatched
per device, each through the same device program on its own copy of the
weights; the launches are asynchronous, so the devices overlap. The NMF
init is drawn at the global batch's shapes from the run's first stream
and sliced, so shards start where the unsharded run starts; each shard
after the first draws its chains from streams of its own
(``fold_seed(seed, SHARD_STREAM, i)``), so live chains are equal to the
unsharded run's in distribution, the frozen chain (``var_rw = 0``) to
rounding, and a mesh of one device bitwise.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from dvae_tpu_torch import tracing
from dvae_tpu_torch.device import resolve_device
from dvae_tpu_torch.enhance.mcem import (
    McemConfig,
    draw_nmf_init,
    fold_seed,
    run_em_fixed_z,
    run_mcem,
    run_peem,
    run_peem_wf,
    run_pmcem,
)
from dvae_tpu_torch.enhance.mh_chain import decoder_widths, extract_decoder_mlp
from dvae_tpu_torch.ops.stft import (
    StftConfig,
    istft_realimag_masked,
    n_stft_frames_clamped,
    samples_for_frames,
    stft_realimag,
)

#: the fold_seed tag of the chain streams of a mesh's shards after the first
SHARD_STREAM = 0x5A4D

#: ``EnhancerConfig.engine`` -> the E-step engine (``enhance.mcem``)
ENGINES = {"mcem": run_mcem, "peem": run_peem, "peem-wf": run_peem_wf, "pmcem": run_pmcem}


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


class _Handle(NamedTuple):
    """One dispatched batch: each shard's device outputs, each shard's
    count of valid cells, the host's side of finishing (lengths, and the
    inputs and frame coverage of the Wiener partition) and the batch's
    sequence number on its ``Enhancer``."""
    shards: list
    cost_w: list
    host: tuple | list
    batch: int


class _Replica(NamedTuple):
    """The weights on one device: the model, its decoder matrices for the
    chain kernel and the encoder's input statistics (or None)."""
    model: torch.nn.Module
    mats: object
    norm: tuple | None


def _blocks(n: int, parts: int) -> list[slice]:
    """``parts`` contiguous equal row blocks of ``n`` rows."""
    per = n // parts
    return [slice(i * per, (i + 1) * per) for i in range(parts)]


@dataclasses.dataclass(frozen=True)
class EnhancerConfig:
    """Same fields as the JAX package's config. This port serves every
    ``y_mode``: ``"none"`` (M1), ``"enc_dec"`` (M2's ``CVAE``, whose
    encoder sees ``[x; y]``) and ``"dec_only"`` (``CVAE_v2``-``v4`` and
    ``DisentangledVAE``); every ``engine`` (:data:`ENGINES`) and every
    ``ablation``; ``aot_dir`` other than None raises NotImplementedError (the
    AOT executable cache is XLA-specific).
    ``ablation``: ``"clean_z"`` starts the latent from the clean
    spectrogram's encoding instead of the mixture's, ``"clean_z_nomcem"``
    pins it there (``run_em_fixed_z``, whatever the engine); both need the
    clean waveforms. ``norm`` is the (mean, std) train statistics of a
    model trained with std_norm: the encoder then sees (|X|^2 - mean) /
    (std + norm_eps), with y concatenated after."""

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
    """Binds a model of any family (:class:`~dvae_tpu_torch.models.VAE`,
    the ``CVAE`` family or ``DisentangledVAE``; ``cfg.y_mode`` must match
    it) to the enhancement program on ``device`` (CUDA unless
    ``device="cpu"`` is passed)."""

    def __init__(self, model, cfg: EnhancerConfig = EnhancerConfig(), mesh=None,
                 device=None):
        if cfg.y_mode not in ("none", "enc_dec", "dec_only"):
            raise ValueError(f"bad y_mode {cfg.y_mode!r}")
        if cfg.wire_dtype not in ("int16", "float32"):
            raise ValueError(f"bad wire_dtype {cfg.wire_dtype!r}")
        if cfg.ablation not in ("none", "clean_z", "clean_z_nomcem"):
            raise ValueError(f"bad ablation {cfg.ablation!r}")
        if cfg.engine not in ENGINES:
            raise ValueError(f"bad engine {cfg.engine!r}")
        if cfg.aot_dir is not None:
            raise NotImplementedError(f"aot_dir={cfg.aot_dir!r}: the AOT executable cache is "
                                      "XLA-specific and is not ported")
        # checked before any device work
        if decoder_widths(model) is None:
            raise ValueError("the E-step engines need a model with a decoder")
        if mesh is None:
            devices = (resolve_device(device),)
        else:
            if mesh.group is not None:
                raise ValueError(
                    f"{mesh!r}: the Enhancer shards a batch over this process's devices; "
                    "a process group's mesh is the trainers' (the sweeps run one process "
                    "per --shard)")
            devices = mesh.devices
            if device is not None and resolve_device(device).type != devices[0].type:
                raise ValueError(f"device={device!r} but the mesh is on {devices[0]}")
            for d in devices:
                resolve_device(d)
        self.cfg = cfg
        self.mesh = mesh
        self.device = devices[0]
        self.model = model.to(self.device).eval()
        self._devices = devices
        self._replicate()
        self.last_cost = None
        self._batches = 0  # batches dispatched: the spans' batch ids

    def _replicate(self) -> None:
        """The weights, decoder matrices and input statistics on each device
        of the mesh, ``self.model`` itself on the first."""
        cfg = self.cfg
        reps = {}
        for d in self._devices:
            if d in reps:
                continue
            model = self.model if not reps else copy.deepcopy(self.model).to(d).eval()
            norm = None if cfg.norm is None else tuple(
                torch.as_tensor(np.asarray(a, np.float32).reshape(-1), device=d)
                for a in cfg.norm)
            reps[d] = _Replica(model, extract_decoder_mlp(model, model.z_dim), norm)
        self._reps = reps
        self.mats, self._norm = reps[self.device].mats, reps[self.device].norm

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
        self._replicate()

    # -- device program ------------------------------------------------------
    @torch.inference_mode()
    def _core(self, rep, xw, x_scale, sw, s_scale, mask, y, seed: int, n_frames: int,
              nmf_init=None):
        """The device program on the device of ``rep`` (a :class:`_Replica`).
        ``sw`` / ``s_scale``: the clean waveforms on the wire (the clean-z
        ablations only, else None); ``nmf_init`` replaces the engine's own
        NMF init draw."""
        cfg = self.cfg

        def power(w, scale):
            re, im = stft_realimag(w.to(torch.float32) * scale[:, None], cfg.stft)
            re, im = re[:, :n_frames], im[:, :n_frames]  # (B, N, F)
            return re, im, re * re + im * im

        re, im, x2 = power(xw, x_scale)
        enc_in = x2 if cfg.ablation == "none" else power(sw, s_scale)[2]
        if rep.norm is not None:  # the encoder input only; the engine sees raw x2
            mean, std = rep.norm
            enc_in = (enc_in - mean) / (std + cfg.norm_eps)
        if cfg.y_mode == "enc_dec":
            enc_in = torch.cat([enc_in, y], -1)
        _, z0, _ = rep.model.encode(enc_in, sample=False)
        engine = run_em_fixed_z if cfg.ablation == "clean_z_nomcem" else ENGINES[cfg.engine]
        res = engine(rep.mats, x2, z0, mask, seed, cfg.mcem, y=y, nmf_init=nmf_init)
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
    def _prepare(self, wavs, ys, max_frames, clean_wavs=None):
        """Pad/bucket the wavs (and labels, and clean waveforms) into the
        wire arrays. Returns (xw, x_scale, sw, s_scale, mask, y, n_pad,
        frames) as CPU tensors / ints; ``sw`` / ``s_scale`` are the clean
        waveforms with their own PCM16 scale, or None without
        ``clean_wavs``; ``y`` is (B, n_pad, Y), each utterance's labels cut
        at its frame count and zero beyond, or None for
        ``y_mode="none"``."""
        cfg = self.cfg
        b = len(wavs)
        frames = [n_stft_frames_clamped(len(w), cfg.stft) for w in wavs]
        if max_frames is not None:
            frames = [max(1, min(f, int(mf))) for f, mf in zip(frames, max_frames)]
        n_pad = -(-max(frames) // cfg.frame_bucket) * cfg.frame_bucket
        t_pad = samples_for_frames(n_pad, cfg.stft)

        def pack(ws):
            x = np.zeros((b, t_pad), dtype=np.float32)
            for i, w in enumerate(ws):
                t_use = min(len(w), t_pad)  # max_frames may leave samples unused
                x[i, :t_use] = np.asarray(w[:t_use], dtype=np.float32)
            x = torch.from_numpy(x)
            if cfg.wire_dtype == "int16":
                return _quantize_pcm16(x)
            return x, torch.ones((b,))

        xw, x_scale = pack(wavs)
        sw, s_scale = (None, None) if clean_wavs is None else pack(clean_wavs)
        mask = torch.zeros((b, n_pad))
        for i in range(b):
            mask[i, :frames[i]] = 1.0
        y = None
        if cfg.y_mode != "none":
            if ys is None:
                raise ValueError(f"y_mode={cfg.y_mode} requires labels")
            y = np.zeros((b, n_pad, np.asarray(ys[0]).shape[-1]), np.float32)
            for i, yi in enumerate(ys):
                yi = np.asarray(yi, np.float32)
                n = min(len(yi), frames[i])
                y[i, :n] = yi[:n]
            y = torch.from_numpy(y)
        return xw, x_scale, sw, s_scale, mask, y, n_pad, frames

    def _dispatch(self, wavs, ys, seed, max_frames, clean_wavs=None):
        """Pad + upload one batch and enqueue its device work (async), one
        shard per device of the mesh. The clean waveforms are read for the
        clean-z ablations only."""
        cfg = self.cfg
        if cfg.ablation == "none":
            clean_wavs = None
        elif clean_wavs is None:
            raise ValueError(f"ablation={cfg.ablation} needs the clean waveforms "
                             "(clean_wavs=...) to encode the clean latent")
        batch = self._batches
        self._batches += 1
        with tracing.span("enhancer.dispatch", batch=batch, utterances=len(wavs)) as sp:
            n_real = len(wavs)
            parts = len(self._devices)
            with tracing.span("enhancer.prepare"):
                if n_real % parts:
                    # pad to a multiple of the mesh with 1-frame silent utterances,
                    # dropped again in _collect
                    pad = parts - n_real % parts
                    silent = np.zeros(cfg.stft.nfft, np.float32)
                    wavs = list(wavs) + [silent] * pad
                    if clean_wavs is not None:
                        clean_wavs = list(clean_wavs) + [silent] * pad
                    if ys is not None:
                        ys = list(ys) + [np.zeros((1, np.asarray(ys[0]).shape[-1]),
                                                  np.float32)] * pad
                    if max_frames is not None:
                        max_frames = list(max_frames) + [1] * pad
                xw, x_scale, sw, s_scale, mask, y, n_pad, frames = self._prepare(
                    wavs, ys, max_frames, clean_wavs)
            sp.set(n_pad=n_pad)
            seed = 0 if seed is None else seed
            nmf_init = None
            if self.mesh is not None:
                # the global batch's NMF init, drawn as the unsharded run draws it
                with tracing.span("enhancer.upload"):
                    nmf_init = draw_nmf_init(seed, len(wavs), n_pad, cfg.stft.nfft // 2 + 1,
                                             cfg.mcem, self.device)
            blocks = _blocks(len(wavs), parts)
            shards = []
            for i, (dev, rows) in enumerate(zip(self._devices, blocks)):
                # a copy from pageable memory waits for the work queued before it
                with tracing.span("enhancer.upload"):
                    wire = [None if t is None else t[rows].to(dev)
                            for t in (xw, x_scale, sw, s_scale, mask, y)]
                    init = None if nmf_init is None else tuple(t[rows].to(dev) for t in nmf_init)
                with tracing.span("enhancer.enqueue"):
                    shards.append(self._core(self._reps[dev], *wire,
                                             seed if i == 0 else fold_seed(seed, SHARD_STREAM, i),
                                             n_pad, init))
            counts = mask.sum(1) * (cfg.stft.nfft // 2 + 1)
            cost_w = [counts[rows].sum().clamp_min(1.0) for rows in blocks]
            lengths = [len(w) for w in wavs[:n_real]]
            if cfg.noise_from_partition:
                cover = [samples_for_frames(fi, cfg.stft) for fi in frames[:n_real]]
                return _Handle(shards, cost_w, (lengths, [np.asarray(w, np.float32)
                                                          for w in wavs[:n_real]], cover), batch)
            return _Handle(shards, cost_w, lengths, batch)

    def _collect(self, handle: _Handle) -> list[tuple[np.ndarray, np.ndarray]]:
        """Pull a dispatched batch back to the host (the shards in order)
        and finalize lengths."""
        with tracing.span("enhancer.collect", batch=handle.batch):
            with tracing.span("enhancer.collect.wait"):
                # each copy waits for the work queued on the stream before it
                shards = [[t.cpu() for t in sh] for sh in handle.shards]
            with tracing.span("enhancer.collect.finish"):
                return self._finish(shards, handle.cost_w, handle.host)

    def _finish(self, shards, cost_w, host) -> list[tuple[np.ndarray, np.ndarray]]:
        """:meth:`_collect` on the host: the shards' outputs copied back
        cut to their lengths, the noise by the Wiener partition and the
        cost."""

        def gather(j):
            return np.concatenate([sh[j].numpy() for sh in shards])

        s_all = gather(0).astype(np.float32) * gather(1)[:, None]
        if self.cfg.noise_from_partition:
            lengths, xs, cover = host
        else:
            lengths = host
            n_all = gather(2).astype(np.float32) * gather(3)[:, None]
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
        if len(shards) == 1:
            self.last_cost = shards[0][-1].numpy()
        else:
            # the masked mean over the whole batch: each shard's mean
            # weighted by its count of valid cells
            w = torch.stack(cost_w).double()
            costs = torch.stack([sh[-1].double() for sh in shards])
            self.last_cost = ((costs * w[:, None]).sum(0) / w.sum()).float().numpy()
        return out

    def enhance_batch(self, wavs: Sequence[np.ndarray],
                      ys: Sequence[np.ndarray] | None = None, seed: int | None = None,
                      max_frames: Sequence[int] | None = None,
                      clean_wavs: Sequence[np.ndarray] | None = None):
        """Enhance a batch of (possibly ragged) utterances.

        Args:
            wavs: float waveforms at ``cfg.stft.fs``.
            ys: per-utterance (n_frames, y_dim) labels, required unless
                ``cfg.y_mode == "none"``.
            seed: integer seed of the engine's random streams (default 0).
            max_frames: optional per-utterance frame cap.
            clean_wavs: per-utterance clean waveforms, required when
                ``cfg.ablation`` is a clean-z mode, ignored otherwise.
        Returns:
            list of (s_hat, n_hat) float32 waveforms, each ``len(wavs[i])``.
        """
        return self.collect(self.dispatch(wavs, ys, seed, max_frames, clean_wavs))

    def dispatch(self, wavs, ys=None, seed: int | None = None, max_frames=None,
                 clean_wavs=None) -> list:
        """The asynchronous half of :meth:`enhance_batch`: enqueue the work
        (split at ``max_device_batch``) and return a handle for
        :meth:`collect`."""
        mdb = self.cfg.max_device_batch
        if len(wavs) == 0:
            return []
        if len(wavs) <= mdb:
            return [self._dispatch(wavs, ys, seed, max_frames, clean_wavs)]
        seed = 0 if seed is None else seed
        return [self._dispatch(wavs[a:a + mdb], _slice(ys, a, a + mdb), fold_seed(seed, j),
                               _slice(max_frames, a, a + mdb), _slice(clean_wavs, a, a + mdb))
                for j, a in enumerate(range(0, len(wavs), mdb))]

    def collect(self, handles: list) -> list[tuple[np.ndarray, np.ndarray]]:
        """Block on a :meth:`dispatch` handle; returns ``[(s_hat, n_hat)]``."""
        out = []
        for h in handles:
            out.extend(self._collect(h))
        return out

    def enhance_stream(self, batches, seed: int | None = None):
        """Pipelined enhancement over an iterable of ``(wavs, ys, max_frames)``
        batches (``ys`` None for ``y_mode="none"``), optionally with a fourth
        ``clean_wavs`` element (the clean-z ablations). Up to
        ``pipeline_depth + 1`` batches are in flight; yields one result list
        per input batch, in order."""
        seed = 0 if seed is None else seed
        mdb = self.cfg.max_device_batch
        depth = max(1, self.cfg.pipeline_depth)

        def sub_batches():
            for i, tup in enumerate(batches):
                wavs, ys, max_frames = tup[:3]
                clean_wavs = tup[3] if len(tup) > 3 else None
                if len(wavs) == 0:
                    yield i, 0, True, None, None, None, None  # one yield per batch
                    continue
                for j, a in enumerate(range(0, len(wavs), mdb)):
                    yield (i, j, a + mdb >= len(wavs), wavs[a:a + mdb],
                           _slice(ys, a, a + mdb), _slice(max_frames, a, a + mdb),
                           _slice(clean_wavs, a, a + mdb))

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

        for i, j, last, wavs, ys, max_frames, clean_wavs in sub_batches():
            handle = None if wavs is None else self._dispatch(
                wavs, ys, fold_seed(fold_seed(seed, i), j), max_frames, clean_wavs)
            pending.append((handle, last))
            if len(pending) > depth:
                out = emit(*pending.popleft())
                if out is not None:
                    yield out
        while pending:
            out = emit(*pending.popleft())
            if out is not None:
                yield out
