"""Tests of the harness's room for a label network of its own, side inputs
and an encoder that sees the labels, run from the repository's root:

    python -m pytest benchmark/test_bench_label_net.py -q

Two trial configurations, defined here and not under ``configs/``, run
whole on the CPU at a small size: the disentangled prior on per-frame
labels from a video VAD network over lip video (offline and served), and
M2's ``CVAE``, whose encoder sees [x; y], on the same labels. This module
also holds the program's side of the trial: the label function the
configuration's ``label_net.program`` names, and an ``EnhanceService``
whose requests carry their video, put in its place for the served trial.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import math
import pathlib
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import check, drive, harness, spec, synth, weights, work  # noqa: E402
from benchmark.reference import dsp, nets, vad  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
HERE = ROOT / "benchmark"
SEED = 2**31 + 19


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# -- the program's side of the trial -------------------------------------------------------


@torch.inference_mode()
def video_labels(net, wavs, side, stft_cfg, stats) -> list[np.ndarray]:
    """Per-utterance (n_frames, 1) VAD probabilities of ``net`` (a
    ``VideoVad``) over the utterances' lip clips, one batched call on the
    network's device: the clips zero-padded to the longest, normalized by
    the configuration's pixel statistics."""
    from dvae_tpu_torch.ops.stft import n_stft_frames_clamped

    dev = next(net.parameters()).device
    ns = [n_stft_frames_clamped(len(w), stft_cfg) for w in wavs]
    clips = np.zeros((len(wavs), max(ns), synth.SIDE, synth.SIDE), np.uint8)
    for i, (clip, n) in enumerate(zip(side["video"], ns)):
        clips[i, :n] = clip[:n]
    mean, std = stats["video"]
    p = net((torch.from_numpy(clips).to(dev).float() - mean) / std).float().cpu().numpy()
    return [p[i, :n, None] for i, n in enumerate(ns)]


def _service_class():
    from dvae_tpu_torch.serving.service import EnhanceService

    class VideoService(EnhanceService):
        """``EnhanceService`` whose requests carry their lip video
        (``submit(wav, video=...)``); the worker labels every item of a
        batch from its video in one call of :func:`video_labels` (an item
        without video, as warm-up's, from a blank clip)."""

        def __init__(self, model, model_class, enh_cfg, cfg, device=None, label_net=None,
                     label_stats=None):
            # every item is labelled here, whatever source the base would use
            super().__init__(model, model_class, enh_cfg,
                             dataclasses.replace(cfg, y_source="self-soft"), device=device)
            self.label_net, self.label_stats = label_net, label_stats
            self._video = {}  # id(wav) -> its clip, until its batch is labelled

        def submit(self, wav, y_source=None, timeout=900.0, _count_stats=True, video=None):
            wav = np.asarray(wav, np.float32)
            if video is not None:
                with self._lock:
                    self._video[id(wav)] = video
            return super().submit(wav, y_source, timeout, _count_stats)

        def _labels_for_batch(self, batch):
            st = self.enh_cfg.stft
            frames = dsp.Stft(st.fs, st.wlen_sec, st.hop_percent).frames
            with self._lock:
                clips = [self._video.pop(id(it.wav), None) for it in batch]
            clips = [np.zeros((frames(len(it.wav)), synth.SIDE, synth.SIDE), np.uint8)
                     if c is None else c for c, it in zip(clips, batch)]
            return video_labels(self.label_net, [it.wav for it in batch], {"video": clips}, st,
                                self.label_stats)

    return VideoService


# -- the trial configurations and their plain references -----------------------------------

M2INFO = json.loads((HERE / "configs" / "m2info.json").read_text())
LABEL_NET = {"class": "VideoVad", "hidden": 24, "num_layers": 2, "emb_dim": 16,
             "conv_features": [4, 8, 8],
             "program": "benchmark.test_bench_label_net:video_labels",
             "stats": {"video": [128.0, 64.0]}}


def _trial_av() -> dict:
    cfg = copy.deepcopy(M2INFO)
    cfg.update(name="trial_av", label_net=copy.deepcopy(LABEL_NET), inputs=["video"],
               labels={"source": "net", "y_dim": 1})
    cfg["model"]["h_dim"] = [32, 32]
    return cfg


def _trial_enc_dec() -> dict:
    cfg = _trial_av()
    cfg.update(name="trial_m2", family="m2")
    cfg["model"] = {"class": "CVAE", "x_dim": 513, "y_dim": 1, "z_dim": 16, "h_dim": [32, 32]}
    cfg["enhancer"]["y_mode"] = "enc_dec"
    return cfg


def _label_params(cfg):
    n = cfg["label_net"]
    return vad.video_vad_params(n["hidden"], n["num_layers"], n["emb_dim"], n["conv_features"])


def _label_flops(cfg, frames):
    n = cfg["label_net"]
    return work.video_vad_flops(frames, n["hidden"], n["num_layers"], n["emb_dim"],
                                n["conv_features"])


def _m2info_reference():
    return spec.load_module(HERE / "configs" / "m2info.py", "bench_config_m2info")


def _av_reference():
    m2info = _m2info_reference()
    return types.SimpleNamespace(params=m2info.params, encoder_mean=m2info.encoder_mean,
                                 decoder=m2info.decoder, labels=None,
                                 label_params=_label_params, net_labels=vad.video_labels,
                                 label_flops=_label_flops)


def _enc_dec_reference():
    def params(cfg):
        m = cfg["model"]
        x, y, z, h = m["x_dim"], m["y_dim"], m["z_dim"], m["h_dim"]
        return (nets.encoder_params("encoder", x + y, h, z)
                + nets.decoder_params("decoder", z + y, h, x))

    def encoder_mean(w, cfg, x2, prec, y):
        return nets.encoder_mean(w, "encoder", len(cfg["model"]["h_dim"]),
                                 torch.cat([x2, y], -1), prec)

    def decoder(w, cfg):
        return nets.decoder(w, "decoder", len(cfg["model"]["h_dim"]), cfg["model"]["z_dim"])

    return types.SimpleNamespace(params=params, encoder_mean=encoder_mean, decoder=decoder,
                                 labels=None, label_params=_label_params,
                                 net_labels=vad.video_labels, label_flops=_label_flops)


@dataclasses.dataclass
class TrialCell(spec.Cell):
    """A cell whose configuration and reference are given, not found."""

    ref: object = None

    @property
    def reference(self):
        return self.ref


#: the trial's limits: the m2info cells' for every stage they share, and the
#: labels' gap between the program's readings at this size (5.96e-08 over 6
#: seeds, offline and served) and the control's (1.15e-05 and up)
LIMITS = {**json.loads((HERE / "workloads" / "m2info.offline.sorted.json").read_text())
          ["limits"], "labels_gap": 2e-6}
del LIMITS["b2_power_rel"]


def trial(cfg, ref, traffic: str, per_layer=()) -> TrialCell:
    """A trial cell at a size a test run holds: 3 EM iterations, 6 short
    mixtures in batches of 3, few requests."""
    cfg = copy.deepcopy(cfg)
    cfg["mcem"]["niter"] = 3
    tr = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    tr.update(pool=6, min_s=1.0, max_s=1.6, batch=3)
    e2e = "offline_audio_s_per_s" if tr["mode"] == "batches" else "serve_p95_s"
    if tr["mode"] == "open_loop":
        tr["rate_per_s"] = 4.0
    end_to_end = [m for m in BENCH["end_to_end"] if m["name"] in (e2e, "setup_s")]
    return TrialCell(f"{cfg['name']}.{traffic}", 1, cfg, tr, {"dispatch": [0, 1]},
                     dict(LIMITS), end_to_end, list(per_layer), ref)


def cpu_run(cell, seconds=0.5, traced=False, seed=SEED):
    """``harness.run`` on the CPU; served with a label network, through the
    trial's service in ``EnhanceService``'s place (the harness imports it
    when it builds the service)."""
    from dvae_tpu_torch.serving import service

    with pytest.MonkeyPatch.context() as mp:
        if cell.config.get("label_net") and cell.traffic["mode"] == "open_loop":
            mp.setattr(service, "EnhanceService", _service_class())
        return harness.run(cell, seed, seconds, traced, torch.device("cpu"), time.monotonic())


def over(out) -> set:
    return {k for k, c in out["checks"].items() if not c["value"] <= c["limit"]}


# -- the trials run correct ---------------------------------------------------------------


@pytest.mark.parametrize("traffic", ["offline", "serve_open"])
def test_the_audio_visual_trial_runs_correct(traffic):
    out = cpu_run(trial(_trial_av(), _av_reference(), traffic))
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["failed"] == 0 and out["result"]["attempted"] > 0
    assert out["checks"]["labels_gap"]["value"] < 2e-7


def test_the_enc_dec_trial_runs_correct():
    out = cpu_run(trial(_trial_enc_dec(), _enc_dec_reference(), "offline"))
    assert out["result"]["correct"], out["checks"]
    assert out["checks"]["encoder_rel"]["value"] < 1e-5


def test_the_control_fails_the_labels(monkeypatch):
    """The reference one precision step lower in the program's place, the
    label network's products included."""
    orig = check.numbers
    monkeypatch.setattr(check, "numbers", lambda *a, **k: orig(*a[:5], True, **k))
    out = cpu_run(trial(_trial_av(), _av_reference(), "offline"))
    assert not out["result"]["correct"]
    assert {"labels_gap", "encoder_rel", "power_rel"} <= over(out), out["checks"]


# -- faults of the labels fail labels_gap ---------------------------------------------------


def _shifted(fn):
    """Labels one frame late."""
    return lambda *a: [np.concatenate([y[:1], y[:-1]]) for y in fn(*a)]


def _weight_scaled(fn):
    """The program's label network with its head's weight x 1.01."""
    def call(net, *a):
        if not getattr(net, "_planted", False):
            with torch.no_grad():
                net.head.weight.mul_(1.01)
            net._planted = True
        return fn(net, *a)
    return call


def _wrong_video(fn):
    """Each mixture labelled from the next mixture's video (its own reversed
    when alone), cycled or cut to its own clip's frames."""
    def call(net, wavs, side, *a):
        clips = side["video"]
        wrong = [clips[(i + 1) % len(clips)] if len(clips) > 1 else clips[i][::-1]
                 for i in range(len(clips))]
        return fn(net, wavs, {"video": [w[np.arange(len(c)) % len(w)]
                                        for w, c in zip(wrong, clips)]}, *a)
    return call


@pytest.mark.parametrize("traffic", ["offline", "serve_open"])
@pytest.mark.parametrize("fault", [_shifted, _weight_scaled, _wrong_video],
                         ids=["shifted-one-frame", "weight-x1.01", "wrong-video"])
def test_a_label_fault_fails_labels_gap(monkeypatch, fault, traffic):
    planted = {}
    real = harness.resolve

    def resolve(name):
        obj = real(name)
        if name == LABEL_NET["program"]:
            return planted.setdefault("fn", fault(obj))
        return obj

    monkeypatch.setattr(harness, "resolve", resolve)
    if traffic == "serve_open":  # the service calls the label function itself
        module = importlib.import_module(LABEL_NET["program"].partition(":")[0])
        monkeypatch.setattr(module, "video_labels", fault(module.video_labels))
    out = cpu_run(trial(_trial_av(), _av_reference(), traffic))
    assert not out["result"]["correct"]
    assert "labels_gap" in over(out), out["checks"]


def test_an_encoder_fed_zeros_for_labels_fails_encoder_rel(monkeypatch):
    """M2's encoder handed [x; 0] in place of [x; y]."""
    from dvae_tpu_torch.models import CVAE

    orig = CVAE.encode

    def encode(self, x, *a, **k):
        x = torch.cat([x[..., :-self.y_dim], torch.zeros_like(x[..., -self.y_dim:])], -1)
        return orig(self, x, *a, **k)

    monkeypatch.setattr(CVAE, "encode", encode)
    out = cpu_run(trial(_trial_enc_dec(), _enc_dec_reference(), "offline"))
    assert not out["result"]["correct"]
    assert "encoder_rel" in over(out), out["checks"]


# -- the label network's work ------------------------------------------------------------------


def test_the_label_networks_work_is_model_work(monkeypatch):
    """``run.flops`` adds the reference's ``label_flops`` of every answered
    utterance to the enhancement's own."""
    seen, parts = {}, {"enhance": [], "label": []}
    enhance_flops = work.enhance_flops

    def counted(*a):
        parts["enhance"].append(enhance_flops(*a))
        return parts["enhance"][-1]

    def label_flops(cfg, frames):
        parts["label"].append(_label_flops(cfg, frames))
        return parts["label"][-1]

    def reader(name):
        return lambda run: seen.setdefault("flops", run.flops)

    monkeypatch.setattr(work, "enhance_flops", counted)
    monkeypatch.setattr(spec, "metric_reader", reader)
    ref = _av_reference()
    ref.label_flops = label_flops
    cpu_run(trial(_trial_av(), ref, "offline", [{"name": "mfu.offline", "unit": "%"}]),
            traced=True)
    assert len(parts["label"]) == len(parts["enhance"]) > 0
    assert min(parts["label"]) > 0
    assert seen["flops"] == sum(parts["enhance"]) + sum(parts["label"])


def test_video_vad_flops_by_hand():
    # convs at 34, 17, 9: 2*9*(34^2*2*1 + 17^2*2*2 + 9^2*2*2); proj 2*81*2*3;
    # LSTM 2*4*1*(3+1); head 2
    want = 2 * 9 * (34 * 34 * 2 + 17 * 17 * 4 + 81 * 4) + 2 * 81 * 2 * 3 + 8 * 4 + 2
    assert work.video_vad_flops(1, 1, 1, 3, (2, 2, 2)) == float(want)
    assert work.video_vad_flops(5, 1, 1, 3, (2, 2, 2)) == 5.0 * want


# -- the reference's network is the port's -------------------------------------------------------


def test_the_reference_video_vad_matches_the_ports_module():
    from dvae_tpu_torch.models import VideoVad
    from benchmark.reference.precision import STATED

    n = LABEL_NET
    w = weights.make(_label_params({"label_net": n}), 5, "cpu", stream=1)
    net = harness._network(n, w, "cpu")
    x = torch.randn((2, 7, 67, 67), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = net(x)
        got = vad.video_vad(w, x, 3, n["num_layers"], STATED)
    assert isinstance(net, VideoVad)
    assert float((got - want).abs().max()) < 1e-6


# -- draws: the label network's, the video, and the four cells' unchanged ---------------------


def test_weights_draw_conv_kernels_and_uniform_lstm_init():
    params = [("k", (64, 32, 3, 3), "xavier"), ("u", (4000, 50), "uniform", 0.25),
              ("b", (7,), "zero"), ("m", (300, 200), "xavier")]
    w = weights.make(params, 9, "cpu", stream=1)
    assert abs(float(w["k"].std()) / math.sqrt(2 / ((64 + 32) * 9)) - 1) < 0.03
    assert abs(float(w["m"].std()) / math.sqrt(2 / 500) - 1) < 0.03
    assert float(w["u"].abs().max()) <= 0.25 and float(w["u"].abs().max()) > 0.249
    assert abs(float(w["u"].std()) / (0.25 / math.sqrt(3)) - 1) < 0.02
    assert not w["b"].any()
    again = weights.make(params, 9, "cpu", stream=1)
    assert all(torch.equal(w[k], again[k]) for k in w)
    other = weights.make(params, 9, "cpu", stream=0)
    assert not torch.equal(w["m"], other["m"])
    with pytest.raises(ValueError):
        weights.make([("x", (2, 2), "normal")], 1, "cpu")


def test_lip_video_follows_the_envelope_and_leaves_the_audio_alone():
    st = dsp.Stft()
    lengths = synth.length_grid(4, 1.0, 2.0)
    wavs, rates = synth.speech(lengths, SEED, "cpu")
    frames = [st.frames(n) for n in lengths]
    clips = synth.lip_video(frames, rates, SEED, "cpu", st.hop / st.fs, st.nfft / st.fs)
    again = synth.lip_video(frames, rates, SEED, "cpu", st.hop / st.fs, st.nfft / st.fs)
    assert all(np.array_equal(a, b) for a, b in zip(clips, again))
    for clip, f, rate in zip(clips, frames, rates):
        assert clip.shape == (f, 67, 67) and clip.dtype == np.uint8
        # the mouth's dark area grows as the envelope swells
        t = np.arange(f) * st.hop / st.fs + st.nfft / st.fs / 2
        swell = np.sin(2 * np.pi * rate * t) ** 2
        dark = (clip < 90).reshape(f, -1).mean(1)
        assert np.corrcoef(swell, dark)[0, 1] > 0.9
    assert all(np.array_equal(a, b) for a, b in zip(wavs, _old_mixtures(lengths, SEED, "cpu")))


def test_the_pool_pairs_each_mixture_with_its_clip():
    traffic = {"pool": 5, "min_s": 1.0, "max_s": 2.0, "order": "shuffled"}
    st = dsp.Stft()
    wavs, side = drive.pool(traffic, SEED, "cpu", st, ["video"])
    assert [len(c) for c in side["video"]] == [st.frames(len(w)) for w in wavs]
    plain, none = drive.pool(traffic, SEED, "cpu", st)
    assert none == {} and all(np.array_equal(a, b) for a, b in zip(wavs, plain))


def _old_weights(params, seed, device):
    """The draw rule of the benchmark's first version, copied."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    sizes = [math.prod(shape) for _, shape, kind in params if kind == "xavier"]
    flat = torch.randn((sum(sizes),), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in params:
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        std = math.sqrt(2.0 / (shape[0] + shape[1]))
        out[name] = (flat[at:at + n] * std).reshape(shape)
        at += n
    return out


def _old_mixtures(lengths, seed, device, fs=16000):
    """The mixtures of the benchmark's first version, copied."""
    lengths = np.asarray(lengths, np.int64)
    n, t_max = len(lengths), int(lengths.max())
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    u = torch.rand((n, 4), generator=gen, device=device, dtype=torch.float64)
    t = torch.arange(t_max, device=device, dtype=torch.float64)[None] / fs
    f0 = 110 + 60 * u[:, :1] + 20 * torch.sin(2 * torch.pi * 0.5 * t)
    phase = 2 * torch.pi * torch.cumsum(f0, -1) / fs
    env = 0.5 + 0.5 * torch.sin(2 * torch.pi * (1.5 + u[:, 1:2]) * t) ** 2
    speech = sum(torch.sin(k * phase) / k for k in range(1, 12)) * env
    noise = torch.randn((n, t_max), generator=gen, device=device, dtype=torch.float32)
    mix = (0.2 * speech).float() + noise * (0.1 + 0.2 * u[:, 2:3]).float()
    host = mix.cpu().numpy()
    return [np.ascontiguousarray(host[i, :lengths[i]]) for i in range(n)]


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_draw_what_they_drew(name):
    """Weights and pool of each cell at a seed, bit for bit as the first
    version drew them."""
    cell = spec.load_cell(name)
    cfg, traffic = cell.config, cell.traffic
    assert "label_net" not in cfg and "inputs" not in cfg
    params = cell.reference.params(cfg)
    new, old = weights.make(params, SEED, "cpu"), _old_weights(params, SEED, "cpu")
    assert list(new) == list(old) and all(torch.equal(new[k], old[k]) for k in new)
    wavs, side = drive.pool(traffic, SEED, "cpu", dsp.Stft(**cfg["stft"]))
    lengths = synth.length_grid(traffic["pool"], traffic["min_s"], traffic["max_s"])
    lengths = drive.ordered(lengths, traffic, np.random.default_rng([SEED, 0]))
    old_wavs = _old_mixtures(lengths, SEED, "cpu")
    assert side == {} and len(wavs) == len(old_wavs)
    assert all(np.array_equal(a, b) for a, b in zip(wavs, old_wavs))
