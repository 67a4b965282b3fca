"""Port parity: the lip-video and audio-visual VAD against the JAX package.

* ``ops/video.py``: ``idct2``, ``preprocess_utterance`` and
  ``preprocess_ntcd_matlab`` agree to 1e-3 absolute on the 0-255 pixel
  scale (both compute the IDCT in float32 and sum in another order);
  ``upsample_frames`` is exact.
* ``LipEncoder``, ``VideoVad`` and ``AVVad`` from converted Flax weights
  agree to 1e-5 (rtol and atol). Two guards: the encoder with symmetric
  conv padding, or with the C, H, W flatten, is off by far more.
* One ``make_lstm_vad_step`` Adam step (lr 1e-3) of each model, with and
  without ``norm`` (the tuple form for ``AVVad``): metrics to rtol 1e-5,
  parameters to 2e-5 absolute, the contract of
  ``test_torch_port_sequence.py``; the eval and predict passes too.
* ``batch_video_utterances`` / ``batch_av_utterances`` over ``.h5`` and
  ``.npz`` files against the JAX batchers over the ``.h5`` ones: video,
  labels and masks exact, the log power as ``test_batch_utterances_
  matches_jax`` holds it, also from the items held in memory; the
  datasets' trims, and the converter's refusals.
* ``builders.utterance_labels`` against the JAX builder's ``_labels_for``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.data.builders as jbuilders
from dvae_tpu.data.av_dataset import AudioVisualDataset as JaxAVDataset
from dvae_tpu.data.av_dataset import VideoDataset as JaxVideoDataset
from dvae_tpu.models.video_vad import AVVad as JaxAVVad
from dvae_tpu.models.video_vad import LipEncoder as JaxLipEncoder
from dvae_tpu.models.video_vad import VideoVad as JaxVideoVad
from dvae_tpu.ops import video as jvideo
from dvae_tpu.ops.stft import StftConfig as JaxStftConfig
from dvae_tpu.train.sequence import batch_av_utterances as jbatch_av
from dvae_tpu.train.sequence import batch_video_utterances as jbatch_video
from dvae_tpu.train.sequence import make_lstm_vad_eval as jmake_eval
from dvae_tpu.train.sequence import make_lstm_vad_predict as jmake_predict
from dvae_tpu.train.sequence import make_lstm_vad_step as jmake_step
from dvae_tpu.train.steps import adam as jadam
from dvae_tpu.train.steps import init_train_state
from dvae_tpu_torch.data import builders as tbuilders
from dvae_tpu_torch.data.av_dataset import AudioVisualDataset, VideoDataset
from dvae_tpu_torch.data.io import save_arrays, write_labels, write_wav
from dvae_tpu_torch.models import AVVad, LipEncoder, VideoVad
from dvae_tpu_torch.models import video_vad as tvideo_vad
from dvae_tpu_torch.models.convert import (
    lstm_vad_state_dict_from_jax,
    video_vad_state_dict_from_jax,
)
from dvae_tpu_torch.ops import stft_power
from dvae_tpu_torch.ops import video as tvideo
from dvae_tpu_torch.ops.stft import StftConfig
from dvae_tpu_torch.train.sequence import (
    batch_av_utterances,
    batch_video_utterances,
    make_lstm_vad_eval,
    make_lstm_vad_predict,
    make_lstm_vad_step,
)
from dvae_tpu_torch.train.steps import adam
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

SIDE, X_DIM, HIDDEN, EMB = 67, 20, 8, 6


def dct_frames(n, seed=0):
    """(n, 67 * 67) DCT coefficients of the shape NTCD's have: large at low
    orders, decaying with the order."""
    rng = np.random.default_rng(seed)
    decay = np.exp(-np.add.outer(np.arange(SIDE), np.arange(SIDE)) / 8.0).ravel()
    return rng.standard_normal((n, SIDE * SIDE)) * decay * 300.0


def test_idct2_and_preprocess_match_jax():
    d = dct_frames(7)
    frames = d.reshape(-1, SIDE, SIDE).astype(np.float32)
    want = np.asarray(jvideo.idct2(jnp.asarray(frames)))
    got = tvideo.idct2(torch.from_numpy(frames)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale * 255, want / scale * 255, rtol=0, atol=1e-3)
    want = jvideo.preprocess_utterance(d, SIDE, SIDE)
    got = tvideo.preprocess_utterance(d, SIDE, SIDE, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == (7, SIDE, SIDE)
    assert got.min() >= 0 and got.max() <= 255
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    y_hat = np.array([0, 1, 0, 0, 1, 0, 0])
    for frame in (0, 1, 4):
        want = jvideo.preprocess_ntcd_matlab(d, frame, SIDE, SIDE, y_hat_hard=y_hat)
        got = tvideo.preprocess_ntcd_matlab(d, frame, SIDE, SIDE, y_hat_hard=y_hat)
        assert got.shape == want.shape == (SIDE, SIDE, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        assert (got[-9:, -9:] == 255.0).all() == bool(y_hat[frame])


@pytest.mark.parametrize("n_in,n_out", [(30, None), (31, 65), (7, 15), (90, 187), (3, 0)])
def test_upsample_frames_is_exact(n_in, n_out):
    frames = np.arange(n_in * 4, dtype=np.float32).reshape(n_in, 2, 2)
    want = jvideo.upsample_frames(frames, 30.0, 62.5, n_out)
    got = tvideo.upsample_frames(frames, 30.0, 62.5, n_out)
    np.testing.assert_array_equal(got, want)


def _pixels(seed, b=2, t=6):
    return (255 * np.random.default_rng(seed).random((b, t, SIDE, SIDE))).astype(np.float32)


def _flax(kind, layers=2, seed=0):
    """(Flax model, its params, the port model with them, the input)."""
    rng = np.random.default_rng(seed + 100)
    v = _pixels(seed) / 255.0
    if kind == "lip":
        jm = JaxLipEncoder(EMB)
        x = v
    elif kind == "video":
        jm = JaxVideoVad(hidden=HIDDEN, num_layers=layers, emb_dim=EMB)
        x = v
    else:
        jm = JaxAVVad(x_dim=X_DIM, hidden=HIDDEN, num_layers=layers, emb_dim=EMB)
        x = (rng.standard_normal(v.shape[:2] + (X_DIM,)).astype(np.float32), v)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), x))
    if kind == "lip":
        tm = LipEncoder(EMB)
        tree = params["params"]
        sd = {k[4:]: w for k, w in video_vad_state_dict_from_jax(
            {"lip": tree, **_stub_lstm_head()}).items() if k.startswith("lip.")}
    else:
        tm = VideoVad(HIDDEN, layers, EMB) if kind == "video" else AVVad(X_DIM, HIDDEN, layers,
                                                                         EMB)
        sd = video_vad_state_dict_from_jax(params)
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm, x


def _stub_lstm_head():
    """One LSTM layer and a head, so that a bare LipEncoder tree converts."""
    gates = {f"i{g}": {"kernel": np.zeros((EMB, 2))} for g in "ifgo"}
    gates.update({f"h{g}": {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)} for g in "ifgo"})
    return {"lstm_0": gates, "head": {"kernel": np.zeros((2, 1)), "bias": np.zeros(1)}}


def _torch_in(x):
    return tuple(map(torch.from_numpy, x)) if isinstance(x, tuple) else torch.from_numpy(x)


@pytest.mark.parametrize("kind,layers", [("lip", 0), ("video", 1), ("video", 2), ("av", 2)])
def test_forward_matches_flax(kind, layers):
    jm, params, tm, x = _flax(kind, layers)
    want = np.asarray(jm.apply(params, x))
    with torch.no_grad():
        got = tm(_torch_in(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_same_padding_is_flax_rule():
    assert [tvideo_vad.same_padding(n) for n in (67, 34, 17, 9, 8)] == \
        [(1, 1), (0, 1), (1, 1), (1, 1), (0, 1)]


@pytest.mark.parametrize("fault", ["symmetric padding", "C, H, W flatten"])
def test_encoder_layout_guards(monkeypatch, fault):
    """The two layout choices matter: with either changed, the encoder
    moves far off the Flax one on the same weights."""
    jm, params, tm, x = _flax("lip")
    want = np.asarray(jm.apply(params, x))
    if fault == "symmetric padding":
        monkeypatch.setattr(tvideo_vad, "same_padding", lambda size: (1, 1))
    else:
        monkeypatch.setattr(tvideo_vad, "flatten_hwc",
                            lambda h: h.reshape(h.shape[0], -1))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 1e-2


def _batch(kind, seed):
    rng = np.random.default_rng(seed)
    b, t = 3, 6
    v = _pixels(seed, b, t)
    y = (rng.uniform(size=(b, t)) > 0.5).astype(np.float32)
    mask = np.zeros((b, t), np.float32)
    for i, n in enumerate((t, 4, 2)):
        mask[i, :n] = 1.0
    if kind == "video":
        return v, y, mask
    a = (rng.standard_normal((b, t, X_DIM)) * 3 - 5).astype(np.float32)
    return (a, v), y, mask


def _norm(kind, which, seed=5):
    rng = np.random.default_rng(seed)
    pixel = (np.float32([[120.0]]), np.float32([[60.0]]))
    if kind == "video":
        return {"none": None, "norm": pixel}[which]
    audio = (rng.standard_normal((X_DIM, 1)).astype(np.float32) - 5,
             rng.uniform(2.0, 4.0, (X_DIM, 1)).astype(np.float32))
    return {"none": None, "norm": (audio, pixel), "pixels only": (None, pixel)}[which]


@pytest.mark.parametrize("kind,which", [("video", "none"), ("video", "norm"), ("av", "none"),
                                        ("av", "norm"), ("av", "pixels only")])
def test_step_eval_predict_match_jax(kind, which):
    jm, params, tm, _ = _flax(kind, 2, seed=3)
    norm = _norm(kind, which)
    x, y, mask = _batch(kind, 1)
    if which == "none":  # raw pixels would saturate the encoder
        x = x / 255.0 if kind == "video" else (x[0], x[1] / 255.0)
    tx = jadam(1e-3)
    jstate, jmet = jmake_step(jm, tx, norm=norm)(
        init_train_state(jm, params, tx), jax.tree.map(jnp.asarray, x), jnp.asarray(y),
        jnp.asarray(mask))
    opt = adam(tm.parameters(), 1e-3)
    met = make_lstm_vad_step(tm, opt, norm=norm)(_torch_in(x), torch.from_numpy(y),
                                                 torch.from_numpy(mask))
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    want = video_vad_state_dict_from_jax(jax.device_get(jstate.params))
    for name, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)

    x2, y2, m2 = _batch(kind, 4)
    if which == "none":
        x2 = x2 / 255.0 if kind == "video" else (x2[0], x2[1] / 255.0)
    jx2 = jax.tree.map(jnp.asarray, x2)
    jev = jmake_eval(jm, norm=norm)(jstate.params, jx2, jnp.asarray(y2), jnp.asarray(m2))
    tev = make_lstm_vad_eval(tm, norm=norm)(_torch_in(x2), torch.from_numpy(y2),
                                            torch.from_numpy(m2))
    for k in tev:
        np.testing.assert_allclose(float(tev[k]), float(jev[k]), rtol=1e-5, err_msg=k)
    p = make_lstm_vad_predict(tm, norm=norm)(_torch_in(x2)).numpy()
    jp = np.asarray(jmake_predict(jm, norm=norm)(jstate.params, jx2))
    np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-5)


def _write_av_files(root, fmt, specs, seed=0):
    """Per utterance (wav samples, video frames, label frames): a noisy wav
    (tone plus noise, as ``test_torch_port_sequence.py`` writes them),
    an ``X`` (67, 67, frames) video and a ``Y`` (1, frames) label file in
    ``fmt``. Returns the (wav, video, label) paths."""
    rng = np.random.default_rng(seed)
    triples = []
    for i, (n_wav, n_vid, n_lab) in enumerate(specs):
        wav = root / f"u{i}.wav"
        if fmt == "h5" or not wav.exists():
            t = np.arange(n_wav) / 16000  # a noisy mixture, as the AV net's input
            w = 0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t) + 0.1 * rng.standard_normal(n_wav)
            write_wav(wav, w / np.abs(w).max() * 0.9, 16000)
        vid, lab = root / f"u{i}_upsampled.{fmt}", root / f"u{i}_vad_labels_upsampled.{fmt}"
        vrng = np.random.default_rng(seed + i)
        save_arrays(vid, {"X": (255 * vrng.random((SIDE, SIDE, n_vid))).astype(np.float32)})
        write_labels(lab, (vrng.uniform(size=(1, n_lab)) > 0.5).astype(np.float32))
        triples.append((wav, vid, lab))
    return triples


# (wav samples, video frames, label frames): video shortest, audio shortest
# (a wav shorter than the frames need, padded), labels shortest, a short wav
AV_SPECS = [(16000, 40, 70), (4000, 60, 60), (9000, 50, 20), (700, 5, 5)]


def test_datasets_trim_as_jax(tmp_path):
    h5 = _write_av_files(tmp_path, "h5", AV_SPECS)
    npz = _write_av_files(tmp_path, "npz", AV_SPECS)
    jv, jav = JaxVideoDataset([(v, lab) for _, v, lab in h5]), JaxAVDataset(h5)
    for triples in (h5, npz):
        tv = VideoDataset([(v, lab) for _, v, lab in triples])
        tav = AudioVisualDataset(triples)
        for i in range(len(triples)):
            for got, want in zip(tv[i], jv[i]):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            for got, want in zip(tav[i], jav[i]):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    unlabelled = AudioVisualDataset([(w, v, None) for w, v, _ in npz])
    assert unlabelled[0][2] is None and len(unlabelled[0][1]) == 40


def test_batchers_match_jax(tmp_path):
    h5 = _write_av_files(tmp_path, "h5", AV_SPECS)
    npz = _write_av_files(tmp_path, "npz", AV_SPECS)
    idx = [0, 1, 2, 3]
    jv = [np.asarray(a) for a in jbatch_video(JaxVideoDataset([(v, lab) for _, v, lab in h5]),
                                               idx)]
    (js, jvid), jy, jm = jax.tree.map(np.asarray, jbatch_av(JaxAVDataset(h5), idx,
                                                            JaxStftConfig(center=True)))
    # in memory, the datasets' items serve in place of the datasets
    mem_v = [JaxVideoDataset([(v, lab) for _, v, lab in h5])[i] for i in idx]
    mem_av = [JaxAVDataset(h5)[i] for i in idx]
    for triples in (h5, npz, "memory"):
        memory = triples == "memory"
        vds = mem_v if memory else VideoDataset([(v, lab) for _, v, lab in triples])
        avds = mem_av if memory else AudioVisualDataset(triples)
        got = batch_video_utterances(vds, idx, device="cpu")
        for g, w in zip(got, jv):
            assert g.shape == w.shape and g.shape[1] % 64 == 0
            np.testing.assert_array_equal(g.numpy(), w)
        before = stft_power.launches
        (ts, tvid), ty, tm = batch_av_utterances(avds, idx, StftConfig(center=True),
                                                 device="cpu")
        assert stft_power.launches == before
        assert ts.shape == js.shape and tvid.shape == jvid.shape
        np.testing.assert_array_equal(tvid.numpy(), jvid)
        np.testing.assert_array_equal(ty.numpy(), jy)
        np.testing.assert_array_equal(tm.numpy(), jm)
        ts = ts.numpy()
        p = np.exp(js)
        resolved = p > 1e-6 * p.max()
        np.testing.assert_allclose(ts[resolved], js[resolved], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.exp(ts), p, rtol=1e-4, atol=1e-6 * p.max())
    with pytest.raises(ValueError, match="labeled triples"):
        batch_av_utterances(AudioVisualDataset([(w, v, None) for w, v, _ in npz]), [0],
                            StftConfig(center=True), device="cpu")


def test_converter_raises_on_unmapped_leaves():
    _, params, _, _ = _flax("av", 1)
    tree = params["params"]
    extra = {**tree, "lip": {**tree["lip"], "conv_9": {"kernel": np.zeros((3, 3, 1, 1))}}}
    with pytest.raises(ValueError, match="not numbered"):
        video_vad_state_dict_from_jax(extra)
    extra = {**tree, "bn": {"scale": np.ones(3)}}
    with pytest.raises(ValueError, match="array leaves"):
        video_vad_state_dict_from_jax(extra)
    with pytest.raises(ValueError, match="no lip/proj"):
        video_vad_state_dict_from_jax({k: v for k, v in tree.items() if k != "lip"})
    with pytest.raises(ValueError, match="not a VideoVad"):
        video_vad_state_dict_from_jax({"lip": tree["lip"]})
    # the audio LSTM's converter does not take the video tree
    with pytest.raises(ValueError, match="not an LSTMVad"):
        lstm_vad_state_dict_from_jax(params)


@pytest.mark.parametrize("labels", ["vad_labels", "ibm_labels"])
def test_utterance_labels_match_jax_builder(labels):
    rng = np.random.default_rng(7)
    t = np.arange(23000) / 16000
    speech = 0.5 * np.sin(2 * np.pi * 180 * t) * (t % 0.4 < 0.25) + 0.003 * rng.standard_normal(
        len(t))
    peak = np.max(np.abs(speech))
    want = jbuilders._labels_for(speech / peak, labels, jbuilders.DEFAULT_STFT)
    got = tbuilders.utterance_labels(speech, labels, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
