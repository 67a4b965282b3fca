"""The batched video labeller (``enhance/labeling.py::video_vad_labels``)
and ``EnhanceService`` with a label network, on the CPU with seeded
weights at a small ``VideoVad``.

The labeller is held to the benchmark's plain reference
(``benchmark/reference/vad.py::video_labels``) on ragged batches; a "net"
service answers each request as the ``Enhancer`` does on the labeller's
labels for the same batch and seed, in batches that mix "net", "ones" and
"zeros" items with fillers; every invalid request raises ValueError before
anything is queued; warm-up runs the network at every bucket; and services
without a label network label as before.
"""

import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from dvae_tpu_torch.enhance.labeling import (
    constant_labels,
    self_soft_labels,
    video_vad_labels,
)
from dvae_tpu_torch.enhance.mcem import McemConfig, fold_seed
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.models import VAE, DisentangledVAE, VideoVad
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped
from dvae_tpu_torch.serving import EnhanceService, ServeConfig
from dvae_tpu_torch.serving import service as tservice
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.reference import vad  # noqa: E402
from benchmark.reference.precision import STATED, Float32Products  # noqa: E402

QUICK = McemConfig(niter=3, nsamples_e_step=2, burnin_e_step=2, nsamples_wf=3, burnin_wf=3)
STFT = StftConfig()
STATS = {"video": [128.0, 64.0]}
NET = dict(hidden=24, num_layers=2, emb_dim=16, conv_features=(4, 8, 8))
TIMEOUT = 120
#: the labeller against the plain reference: both run the same float32
#: arithmetic, summed in another order in the convs and the LSTM's gate
#: products (6e-8 at this size); a head weight x 1.01 moves the labels by
#: ~1e-4 and a shift by a frame by ~1e-3
TOL = 2e-6


def _net(seed=3):
    return VideoVad(**NET, generator=torch.Generator().manual_seed(seed)).eval()


def _wavs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(max(lengths)) / 16000
    x = 0.4 * np.sin(2 * np.pi * 210 * t)
    return [(x[:n] + 0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


def _clip(n_frames, seed=0, extra=0):
    rng = np.random.default_rng(seed + 100)
    return rng.integers(0, 256, (n_frames + extra, 67, 67)).astype(np.uint8)


def _frames(wav):
    return n_stft_frames_clamped(len(wav), STFT)


def _reference(net, wavs, clips):
    cfg = {"label_net": {"conv_features": list(NET["conv_features"]),
                         "num_layers": NET["num_layers"], "stats": STATS},
           "stft": {"fs": STFT.fs, "wlen_sec": STFT.wlen_sec, "hop_percent": STFT.hop_percent}}
    w = {k: v.detach() for k, v in net.state_dict().items()}
    with Float32Products():
        return [y.numpy() for y in vad.video_labels(w, cfg, wavs, {"video": clips}, STATED)]


def _gap(got, want) -> float:
    return max(float(np.abs(a - b).max()) for a, b in zip(got, want))


# -- the labeller --------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [None, 6], ids=["as-many-rows", "padded-rows"])
def test_video_vad_labels_match_the_plain_reference(rows):
    net = _net()
    wavs = _wavs((16000, 9000, 23000, 500))
    clips = [_clip(_frames(w), i, extra=3 * i) for i, w in enumerate(wavs)]
    got = video_vad_labels(net, wavs, {"video": clips}, STFT, STATS, rows=rows)
    assert [y.shape for y in got] == [(_frames(w), 1) for w in wavs]
    assert all(y.dtype == np.float32 for y in got)
    want = _reference(net, wavs, clips)
    assert _gap(got, want) < TOL
    # the faults the tolerance has to catch
    shifted = [np.concatenate([y[:1], y[:-1]]) for y in got]
    assert _gap(shifted, want) > 10 * TOL
    with torch.no_grad():
        net.head.weight.mul_(1.01)
    scaled = video_vad_labels(net, wavs, {"video": clips}, STFT, STATS, rows=rows)
    assert _gap(scaled, want) > 10 * TOL


def test_video_vad_labels_drop_frames_past_the_audio_and_pad_to_the_bucket(monkeypatch):
    net = _net()
    wavs = _wavs((12000, 7000))
    clips = [_clip(_frames(w), i) for i, w in enumerate(wavs)]
    longer = [np.concatenate([c, _clip(9, 7)]) for c in clips]
    seen = []
    forward = net.forward
    monkeypatch.setattr(net, "forward", lambda v: seen.append(tuple(v.shape)) or forward(v))
    a = video_vad_labels(net, wavs, {"video": clips}, STFT, STATS, frame_bucket=64, rows=4)
    b = video_vad_labels(net, wavs, {"video": longer}, STFT, STATS, frame_bucket=64, rows=4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert seen == [(4, 64, 67, 67)] * 2
    with pytest.raises(ValueError, match="frames"):
        video_vad_labels(net, wavs, {"video": [clips[0], clips[1][:-1]]}, STFT, STATS)
    with pytest.raises(ValueError, match="uint8"):
        video_vad_labels(net, wavs, {"video": [c.astype(np.float32) for c in clips]}, STFT,
                         STATS)
    with pytest.raises(ValueError, match="clips"):
        video_vad_labels(net, wavs, {"video": clips[:1]}, STFT, STATS)


# -- the service -------------------------------------------------------------------------------


def _prior(seed=0):
    torch.manual_seed(seed)
    return DisentangledVAE(513, 1, 4, (16, 16))


def _av_service(net=None, **kw):
    cfg = dict(batch_size=4, batch_window_ms=5.0, warmup_buckets=(), max_audio_seconds=30.0,
               y_source="net", seed=7)
    cfg.update(kw)
    return EnhanceService(_prior(), "v5", EnhancerConfig(mcem=QUICK, y_mode="dec_only"),
                          ServeConfig(**cfg), device="cpu",
                          label_net=net if net is not None else _net(), label_stats=STATS)


def _park(svc):
    """Stop the worker so queued items stay queued."""
    svc._stop.set()
    svc._worker.join(timeout=10)
    assert not svc._worker.is_alive()


def _unpark(svc):
    svc._stop.clear()
    svc._worker = threading.Thread(target=svc._run, daemon=True, name="enhance-worker")
    svc._worker.start()


def test_a_net_service_answers_as_the_enhancer_does_on_the_labellers_labels():
    """One batch of two "net" items, a "ones" and a "zeros" item, padded
    with a filler to the batch of 4: the labels the Enhancer got and the
    answers are those of ``video_vad_labels`` and ``Enhancer.enhance_batch``
    on the same batch and seed."""
    net = _net()
    svc = _av_service(net, batch_window_ms=1000.0)
    got = []
    real = svc.enhancer.dispatch

    def spy(wavs, ys=None, seed=None, **kw):
        got.append((list(wavs), [np.array(y) for y in ys], seed))
        return real(wavs, ys, seed, **kw)

    svc.enhancer.dispatch = spy
    xs = _wavs((11000, 8000, 9500), seed=2)
    clips = [_clip(_frames(xs[0]), 1), _clip(_frames(xs[1]), 2, extra=5)]
    try:
        _park(svc)
        items = [svc._admit(xs[0], "net", True, video=clips[0]),
                 svc._admit(xs[1], "net", True, video=clips[1]),
                 svc._admit(xs[2], "ones", True)]
        items.append(svc._admit(xs[0], "zeros", True))
        # four items fill the batch; a second batch of one "net" item and
        # three fillers follows
        items.append(svc._admit(xs[2], "net", True, video=_clip(_frames(xs[2]), 3)))
        _unpark(svc)
        outs = [svc._await(it, TIMEOUT) for it in items]
    finally:
        svc.close()
    assert len(got) == 2 and [g[2] for g in got] == [fold_seed(7, 0), fold_seed(7, 1)]
    (wavs0, ys0, _), (wavs1, ys1, _) = got
    nfft = STFT.nfft
    assert [len(w) for w in wavs1] == [len(xs[2])] + [nfft] * 3
    net_y = video_vad_labels(net, xs[:2], {"video": clips}, STFT, STATS, rows=4)
    want = net_y + [constant_labels(_frames(xs[2]), 1, "ones"),
                    constant_labels(_frames(xs[0]), 1, "zeros")]
    assert all(np.array_equal(a, b) for a, b in zip(ys0, want))
    assert all(not y.any() and y.shape == (1, 1) for y in ys1[1:])
    assert _gap(ys0[:2], _reference(net, xs[:2], clips)) < TOL
    enh = Enhancer(svc.enhancer.model, svc.enh_cfg, device="cpu")
    again = enh.enhance_batch(wavs0, ys0, seed=fold_seed(7, 0))
    for (s, n), (s2, n2) in zip(outs[:4], again):
        np.testing.assert_array_equal(s, s2)
        np.testing.assert_array_equal(n, n2)


def test_every_invalid_request_or_service_raises_before_anything_is_queued():
    prior_cfg = EnhancerConfig(mcem=QUICK, y_mode="dec_only")
    with pytest.raises(ValueError, match="label_net"):
        EnhanceService(_prior(), "v5", prior_cfg, ServeConfig(y_source="net"), device="cpu")
    with pytest.raises(ValueError, match="chunk_seconds"):
        _av_service(chunk_seconds=4.0)
    with pytest.raises(ValueError, match="m1"):
        EnhanceService(VAE(513, 4, (16, 16)), "m1", EnhancerConfig(mcem=QUICK),
                       ServeConfig(warmup_buckets=()), device="cpu", label_net=_net())
    x = _wavs((9000,))[0]
    good = _clip(_frames(x))
    svc = _av_service()
    try:
        bad = {"no video": None, "wrong shape": good[:, :60], "wrong dtype": good.astype(np.int16),
               "too few frames": good[:-1], "2-d": good[0]}
        for what, clip in bad.items():
            with pytest.raises(ValueError):
                svc.submit(x, video=clip)
            with pytest.raises(ValueError):
                svc.submit_stream(x, video=clip)
        with pytest.raises(ValueError, match="net"):
            svc.submit(x, "ones", video=good)
        with pytest.raises(ValueError, match="video"):
            svc.submit_stream_from(iter([x]), len(x), "net")
        assert svc._q.qsize() == 0 and svc._unfinished == 0
    finally:
        svc.close()
    plain = EnhanceService(_prior(), "v5", prior_cfg, ServeConfig(warmup_buckets=()),
                           device="cpu")
    try:
        with pytest.raises(ValueError, match="no label network"):
            plain.submit(x, video=good)
        with pytest.raises(ValueError, match="no label network"):
            plain.submit(x, "net")
        assert plain._q.qsize() == 0 and plain._unfinished == 0
    finally:
        plain.close()


def test_warmup_runs_the_network_at_every_bucket(monkeypatch):
    net = _net()
    seen = []
    forward = net.forward
    monkeypatch.setattr(net, "forward", lambda v: seen.append(tuple(v.shape)) or forward(v))
    svc = _av_service(net, y_source="ones")
    try:
        svc.warmup(buckets=(64, 128))
        assert svc.warm_buckets == [64, 128]
        assert seen == [(4, 64, 67, 67), (4, 128, 67, 67)]
        # a served "net" request of the first bucket runs at its warmed shape
        x = _wavs((9000,))[0]
        svc.submit(x, "net", timeout=TIMEOUT, video=_clip(_frames(x)))
        assert seen[-1] == (4, 64, 67, 67)
        assert svc.stats_snapshot()["requests"] == 1
    finally:
        svc.close()


def test_services_without_a_label_network_label_as_before(monkeypatch):
    """Self-soft, constant-label and m1 services never call the labeller,
    and their labels are the classifier's and the constants."""
    monkeypatch.setattr(tservice, "video_vad_labels",
                        lambda *a, **k: pytest.fail("the video labeller ran"))
    model = _prior()
    svc = EnhanceService(model, "v5", EnhancerConfig(mcem=QUICK, y_mode="dec_only"),
                         ServeConfig(batch_size=4, warmup_buckets=()), device="cpu")
    xs = _wavs((9000, 6000), seed=4)
    try:
        assert svc.label_net is None
        batch = [tservice._Item(xs[0], "self-soft"), tservice._Item(xs[1], "zeros")]
        ys = svc._labels_for_batch(batch)
        want = self_soft_labels(model, xs[:1], STFT, 1, "classify_from_x")[0]
        np.testing.assert_array_equal(ys[0], want)
        np.testing.assert_array_equal(ys[1], constant_labels(_frames(xs[1]), 1, "zeros"))
        svc.warmup(buckets=(64,))
        for src in ("self-soft", "ones"):
            s, n = svc.submit(xs[0], src, timeout=TIMEOUT)
            assert len(s) == len(n) == len(xs[0])
    finally:
        svc.close()
    m1 = EnhanceService(VAE(513, 4, (16, 16)), "m1", EnhancerConfig(mcem=QUICK),
                        ServeConfig(warmup_buckets=()), device="cpu")
    try:
        m1.warmup(buckets=(64,))
        assert len(m1.submit(xs[1], timeout=TIMEOUT)[0]) == len(xs[1])
    finally:
        m1.close()
