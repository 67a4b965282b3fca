"""Port parity: the matmul-DFT STFT and masked ISTFT against ``dvae_tpu.ops.stft``.

Both sides run f32 matmuls over 1024-sample frames, so spectra agree to
~1e-6 relative; tolerance rtol 1e-5 with an absolute floor of 1e-4 of the
spectrum's peak (cancellation in near-zero bins). Waveforms agree to 1e-5
absolute wherever the squared-window normalizer is >= 1e-2; in the first
and last few samples of an utterance it falls to ~1e-10 and divides the
matmuls' rounding up, so there the bound is 1e-3.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvae_tpu_torch.ops import stft as tstft
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

# dvae_tpu.ops re-exports a function named ``stft`` over its module
jstft = importlib.import_module("dvae_tpu.ops.stft")

CFG_J, CFG_T = jstft.StftConfig(), tstft.StftConfig()


def _ragged_batch(seed=0, lengths=(9000, 12345, 7000)):
    rng = np.random.default_rng(seed)
    t_pad = max(lengths)
    x = np.zeros((len(lengths), t_pad), np.float32)
    for i, n in enumerate(lengths):
        tt = np.arange(n) / 16000.0
        x[i, :n] = 0.3 * np.sin(2 * np.pi * (150 + 50 * i) * tt) + 0.05 * rng.standard_normal(n)
    return x, lengths


def test_padded_length_and_frame_counts_match():
    # lengths where the float end-pad quirk fires despite n % hop == 0, and
    # where it does not
    lengths = [256 * k for k in range(1, 400)] + [1000, 1023, 1024, 1025, 500, 81600]
    for n in lengths:
        assert tstft.padded_length(n, CFG_T) == jstft.padded_length(n, CFG_J)
        assert tstft.n_stft_frames(n, CFG_T) == jstft.n_stft_frames(n, CFG_J)
        assert tstft.n_stft_frames_clamped(n, CFG_T) == jstft.n_stft_frames_clamped(n, CFG_J)
    assert any(tstft.padded_length(n, CFG_T) != n for n in lengths if n % 256 == 0)
    for nf in (1, 5, 320):
        assert tstft.samples_for_frames(nf, CFG_T) == jstft.samples_for_frames(nf, CFG_J)
    assert dataclasses_equal(CFG_T, CFG_J)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b) and \
        (a.nfft, a.hop, a.n_bins) == (b.nfft, b.hop, b.n_bins)


@pytest.mark.parametrize("center", [False, True])
def test_stft_and_power_match_jax(center):
    x, _ = _ragged_batch()
    cj = jstft.StftConfig(center=center)
    ct = tstft.StftConfig(center=center)
    jre, jim = (np.asarray(a) for a in jstft.stft_realimag(jnp.asarray(x), cj))
    tre, tim = (a.numpy() for a in tstft.stft_realimag(torch.from_numpy(x), ct))
    assert tre.shape == jre.shape
    floor = 1e-4 * np.abs(jre).max()
    np.testing.assert_allclose(tre, jre, rtol=1e-5, atol=floor)
    np.testing.assert_allclose(tim, jim, rtol=1e-5, atol=floor)
    jp = np.asarray(jstft.power_spectrogram(jnp.asarray(x), cj))
    tp = tstft.power_spectrogram(torch.from_numpy(x), ct).numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-4 * jp.max())


def test_istft_masked_matches_jax_on_ragged_batch():
    x, lengths = _ragged_batch(1)
    jre, jim = jstft.stft_realimag(jnp.asarray(x), CFG_J)
    n_frames = jre.shape[1]
    frames = [jstft.n_stft_frames(n, CFG_J) for n in lengths]
    mask = np.zeros((len(lengths), n_frames), np.float32)
    for i, f in enumerate(frames):
        mask[i, :f] = 1.0
    jre, jim = np.asarray(jre) * mask[..., None], np.asarray(jim) * mask[..., None]
    jy = np.asarray(jstft.istft_realimag_masked(jnp.asarray(jre), jnp.asarray(jim),
                                                jnp.asarray(mask), CFG_J))
    ty = tstft.istft_realimag_masked(torch.from_numpy(jre), torch.from_numpy(jim),
                                     torch.from_numpy(mask), CFG_T).numpy()
    assert ty.shape == jy.shape
    w2 = (tstft.get_window("hann", 1024) ** 2).astype(np.float32)
    wss = tstft._overlap_add(torch.from_numpy(mask[..., None] * w2), 256).numpy()
    good = wss >= 1e-2
    np.testing.assert_allclose(ty[good], jy[good], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ty, jy, atol=1e-3)
    # each utterance reconstructs over its own frames' coverage
    for i, f in enumerate(frames):
        n = min(tstft.samples_for_frames(f, CFG_T), lengths[i])
        ok = good[i, :n]
        np.testing.assert_allclose(ty[i, :n][ok], x[i, :n][ok], atol=1e-4)


def test_overlap_add_irregular_hop_matches_jax():
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((2, 5, 12)).astype(np.float32)
    for hop in (3, 5):
        want = np.asarray(jstft._overlap_add(jnp.asarray(frames), hop))
        got = tstft._overlap_add(torch.from_numpy(frames), hop).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _spectrogram(center, seed=3, lengths=(12345, 7000)):
    """A (2, frames, 513) complex64 STFT of a seeded signal pair (the
    shorter one zero-padded), and the longer one's length."""
    x, _ = _ragged_batch(seed, lengths)
    re, im = jstft.stft_realimag(jnp.asarray(x), jstft.StftConfig(center=center))
    return (np.asarray(re) + 1j * np.asarray(im)).astype(np.complex64), x


@pytest.mark.parametrize("length", [None, "short", "long"])
@pytest.mark.parametrize("center", [False, True], ids=["uncentred", "centred"])
def test_istft_and_istft_np_match_jax(center, length):
    """``istft`` (on a complex tensor) and ``istft_np`` against JAX's on the
    same spectrogram: centre trimming, and ``length`` shorter than the
    signal (truncation) or longer (zero padding). Within 1e-5 where the
    squared-window normalizer is >= 1e-2; at the edges, where it falls to
    ~1e-10 and divides the products' rounding up, within 1e-3 (the ISTFT
    quirk of ROADMAP §C). ``istft_np`` is ``istft`` on the CPU."""
    S, x = _spectrogram(center)
    cj, ct = jstft.StftConfig(center=center), tstft.StftConfig(center=center)
    full = (S.shape[1] - 1) * ct.hop + ct.nfft - (ct.nfft if center else 0)
    n = {None: None, "short": full - 777, "long": full + 500}[length]
    jy = np.asarray(jstft.istft(jnp.asarray(S), cj, length=n))
    jn = jstft.istft_np(S, cj, length=n)
    ty = tstft.istft(torch.from_numpy(S), ct, length=n)
    tn = tstft.istft_np(S, ct, length=n)
    assert ty.dtype == torch.float32 and tn.dtype == np.float32
    ty = ty.numpy()
    assert ty.shape == jy.shape == tn.shape == jn.shape == (2, full if n is None else n)
    wss = jstft._window_sumsquare("hann", ct.nfft, ct.hop, S.shape[1])
    if center:
        wss = wss[ct.nfft // 2:-(ct.nfft // 2)]
    wss = np.pad(wss, (0, max(0, jy.shape[-1] - len(wss))))[:jy.shape[-1]]
    good = wss >= 1e-2
    for got, want in ((ty, jy), (ty, jn)):
        np.testing.assert_allclose(got[:, good], want[:, good], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(tn, ty)
    if n is not None and n > full:  # librosa's zero padding
        assert not np.any(ty[:, full:]) and not np.any(tn[:, full:])
    # the longer signal reconstructs where the normalizer is full
    m = min(x.shape[1], ty.shape[1])
    ok = good[:m] & (np.arange(m) < x.shape[1] - ct.nfft)
    np.testing.assert_allclose(ty[0, :m][ok], x[0, :m][ok], atol=1e-4)


def test_istft_rejects_bad_bins_and_keeps_the_tiny_guard():
    """Both copies raise on a bin count other than nfft / 2 + 1; with one
    frame and ``center`` off the normalizer is 0 at the first sample, which
    the tiny-threshold guard leaves undivided (0 there, not NaN), as JAX's."""
    cfg = tstft.StftConfig(center=False)
    rng = np.random.default_rng(4)
    S = (rng.standard_normal((1, 513)) + 1j * rng.standard_normal((1, 513))).astype(np.complex64)
    ty = tstft.istft(torch.from_numpy(S), cfg).numpy()
    tn = tstft.istft_np(S, cfg)
    jy = np.asarray(jstft.istft(jnp.asarray(S), jstft.StftConfig(center=False)))
    assert np.isfinite(ty).all() and np.isfinite(tn).all() and ty[0] == tn[0] == jy[0] == 0.0
    # the normalizer divides by down to ~1e-10 here: the values reach ~1e4
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-3)
    bad = np.ascontiguousarray(S[:, :512])
    with pytest.raises(ValueError, match="513 bins"):
        tstft.istft(torch.from_numpy(bad), cfg)
    with pytest.raises(ValueError, match="513 bins"):
        tstft.istft_np(bad, cfg)
