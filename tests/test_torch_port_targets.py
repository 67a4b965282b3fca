"""Port parity: the VAD / IBM label generators and the labelled frame-set
builder.

The same numpy inputs go through ``dvae_tpu.ops.targets`` and
``dvae_tpu_torch.ops.targets``. The VAD agrees exactly: both sum the same
f32 frames and compare against the same threshold, and a random signal
puts no frame within rounding of it. The IBM and the legacy threshold
masks agree exactly on the same complex input. The labelled
``build_frames`` is held against the JAX builder's per-utterance core
(``_labels_for`` and the trim): VAD labels exactly, IBM labels on all but
at most 1e-4 of the bins, and only on bins whose JAX dB value lies within
1e-3 dB of the utterance's threshold, since the port takes the IBM from
the power rows and the JAX builder from the complex matmul DFT.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.ops.targets as jt
import dvae_tpu_torch.ops.targets as tt
from dvae_tpu.data.builders import DEFAULT_STFT as J_DEFAULT_STFT
from dvae_tpu.data.builders import _labels_for
from dvae_tpu_torch.data.builders import build_frames
from dvae_tpu_torch.ops.stft import StftConfig, padded_length
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

jstft = importlib.import_module("dvae_tpu.ops.stft")


def _quirk_length(cfg=StftConfig()):
    """A multiple of hop at which the end-pad quirk still adds a hop."""
    return next(n for n in range(256 * 40, 256 * 120, 256) if padded_length(n, cfg) != n)


def _speech(n, seed, gated=True):
    """A harmonic signal switched on and off (frames with and without
    energy) plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    phase = 2 * np.pi * np.cumsum(120 + 40 * np.sin(2 * np.pi * 0.7 * t)) / 16000
    s = sum(np.sin(k * phase) / k for k in range(1, 9))
    if gated:
        s = s * (np.sin(2 * np.pi * 1.3 * t) > 0)
    return (0.3 * s + 1e-3 * rng.standard_normal(n)).astype(np.float32)


def _complex(shape, seed, scales=(0.01, 1.0, 10.0)):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return (X * rng.choice(scales, size=(shape[0], 1))).astype(np.complex64)


@pytest.mark.parametrize("center", [False, True], ids=["nocenter", "center"])
def test_vad_matches_jax_exactly(center):
    cfg = StftConfig(center=center)
    jcfg = jstft.StftConfig(center=center)
    for n, seed in ((16000, 0), (_quirk_length(), 1), (11111, 2)):
        x = _speech(n, seed)
        want = np.asarray(jt.clean_speech_vad(jnp.asarray(x), jcfg))
        got = tt.clean_speech_vad(torch.from_numpy(x), cfg).numpy()
        assert got.dtype == np.float32 and 0 < got.sum() < got.size
        np.testing.assert_array_equal(got, want)
    # a batch of rows is the rows one by one (the minimum is per row)
    xs = np.stack([_speech(16000, s) * g for s, g in ((3, 1.0), (4, 0.01))])
    want = np.asarray(jt.clean_speech_vad(jnp.asarray(xs), jcfg))
    np.testing.assert_array_equal(tt.clean_speech_vad(torch.from_numpy(xs), cfg).numpy(), want)


def test_ibm_and_gated_ibm_match_jax():
    X = _complex((40, 513), 5)
    want = np.asarray(jt.clean_speech_ibm(jnp.asarray(X)))
    got = tt.clean_speech_ibm(torch.from_numpy(X)).numpy()
    assert got.dtype == np.float32 and 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want)
    # the magnitude gives the same mask as the complex STFT
    np.testing.assert_array_equal(tt.clean_speech_ibm(torch.from_numpy(np.abs(X))).numpy(), want)
    # batched: one peak per utterance
    Xb = np.stack([X, X * 1e-3])
    np.testing.assert_array_equal(tt.clean_speech_ibm(torch.from_numpy(Xb)).numpy(),
                                  np.asarray(jt.clean_speech_ibm(jnp.asarray(Xb))))

    x = np.concatenate([np.zeros(8000, np.float32), _speech(12000, 6, gated=False)])
    S = np.asarray(jstft.stft(jnp.asarray(x), J_DEFAULT_STFT)).astype(np.complex64)
    want = np.asarray(jt.noise_robust_clean_speech_ibm(jnp.asarray(x), jnp.asarray(S),
                                                       J_DEFAULT_STFT))
    got = tt.noise_robust_clean_speech_ibm(torch.from_numpy(x), torch.from_numpy(S),
                                           StftConfig()).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[:20].any() and got[-10:].any()  # silence gated off


def test_legacy_threshold_family_matches_jax():
    for n_bins in (513, 600):
        for g, w in zip(tt.voiced_unvoiced_split_characteristic(n_bins),
                        jt.voiced_unvoiced_split_characteristic(n_bins)):
            np.testing.assert_array_equal(g, w)
    X, N = _complex((11, 513), 7), _complex((11, 513), 8, (1.0,))
    want_s, want_n = jt.noise_aware_ibm(jnp.asarray(X), jnp.asarray(N))
    got_s, got_n = tt.noise_aware_ibm(torch.from_numpy(X), torch.from_numpy(N))
    assert got_s.dtype == torch.bool and 0 < got_s.float().mean() < 1
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    X = _complex((9, 513), 9, (0.05, 1.0, 20.0))
    got = tt.threshold_ibm(torch.from_numpy(X))
    assert got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt.threshold_ibm(jnp.asarray(X))))


def _jax_builder_core(wavs, labels, trims):
    """build_frame_dataset's per-utterance core: peak normalization, the
    power rows, ``_labels_for``, the trim, and the JAX IBM's dB values."""
    ys, dbs = [], []
    for w, m in zip(wavs, trims):
        speech = w / np.max(np.abs(w))
        spec = np.asarray(jstft.power_spectrogram(jnp.asarray(speech, jnp.float32),
                                                  J_DEFAULT_STFT)).T
        label = _labels_for(speech, labels, J_DEFAULT_STFT)
        S = np.asarray(jstft.stft(jnp.asarray(speech), J_DEFAULT_STFT))
        db = 20.0 * np.log10(np.abs(S) + 1e-8)
        n = min(spec.shape[1], label.shape[1], m)
        ys.append(label[:, :n].T)
        dbs.append(db[:n] - (db.max() - 50.0))
    return np.concatenate(ys), np.concatenate(dbs)


@pytest.mark.parametrize("labels", ["vad_labels", "ibm_labels"])
def test_labelled_build_frames_matches_jax_builder(labels):
    wavs = [_speech(n, s) * g for n, s, g in
            ((16000, 10, 1.0), (_quirk_length(), 11, 0.3), (11111, 12, 2.0), (30000, 13, 1.0))]
    trims = [1000, 20, 1000, 1000]
    got = build_frames(wavs, max_frames=trims, device="cpu", labels=labels)
    plain = build_frames(wavs, max_frames=trims, device="cpu")
    # the rows and statistics are those of the unlabelled build, bit for bit
    for a, b in zip(got[:4], plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert plain.y is None
    want, margin = _jax_builder_core(wavs, labels, trims)
    assert got.y.dtype == np.float32 and got.y.shape == want.shape == (
        len(got.x), 1 if labels == "vad_labels" else 513)
    assert 0 < want.mean() < 1
    if labels == "vad_labels":
        np.testing.assert_array_equal(got.y, want)
        return
    off = got.y != want
    assert off.mean() <= 1e-4
    assert (np.abs(margin[off]) < 1e-3).all(), margin[off]


def test_labelled_build_frames_rejects_unknown_labels():
    with pytest.raises(ValueError, match="unknown labels"):
        build_frames([_speech(16000, 0)], device="cpu", labels="video")
