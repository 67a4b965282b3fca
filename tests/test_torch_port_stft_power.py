"""Port parity: the STFT (log-)power dispatchers and the frame-set builder.

On the CPU the port's ``power_spectrogram`` / ``log_power_spectrogram``
take their plain version (the matmul DFT), which is held here against the
Pallas kernel in interpret mode (``_interpret_reference``) and against
``dvae_tpu.ops.stft``, at the tolerances of ``tests/test_pallas_stft.py``:
both sides are f32 products over 1024-sample frames summed in another order.
Power agrees to rtol 1e-4 with an absolute floor of 1e-6. Log power agrees
to 1e-4 (rtol and atol) on bins above 1e-6 of the peak power, the bound
``chip_smoke.py`` holds the kernel to; in deeper bins the products'
rounding (~1e-7 of the frame's amplitude) is a large part of the bin, so
there exp(log power) is held to the power tolerance instead.
The kernel itself is held against the plain version on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu_torch.ops as tops
from dvae_tpu.data.builders import DEFAULT_STFT as J_DEFAULT_STFT
from dvae_tpu.data.builders import _empirical_std as j_empirical_std
from dvae_tpu.ops.pallas_stft import _interpret_reference
from dvae_tpu_torch.data.builders import DEFAULT_STFT, build_frames
from dvae_tpu_torch.ops import stft as tstft
from dvae_tpu_torch.ops import stft_power
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

# dvae_tpu.ops re-exports a function named ``stft`` over its module
jstft = importlib.import_module("dvae_tpu.ops.stft")


def _quirk_length(cfg=tstft.StftConfig()):
    """A multiple of hop at which the end-pad quirk still adds a hop."""
    return next(n for n in range(256 * 40, 256 * 120, 256)
                if tstft.padded_length(n, cfg) != n)


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("log_eps", [None, 1e-12], ids=["power", "log"])
@pytest.mark.parametrize("center", [False, True], ids=["nocenter", "center"])
def test_cpu_dispatch_matches_pallas_interpreter_and_xla(center, log_eps):
    ct, cj = tstft.StftConfig(center=center), jstft.StftConfig(center=center)
    # frame counts that are not a multiple of any tile, one where the
    # end-pad quirk fires, and a batch of two
    cases = [_signal(20480, 0)[None], _signal(12345, 1)[None],
             _signal(_quirk_length(), 2)[None],
             np.stack([_signal(9000, 3), _signal(9000, 4)])]
    before = stft_power.launches
    for x in cases:
        if log_eps is None:
            got = tops.power_spectrogram(torch.from_numpy(x), ct).numpy()
            xla = np.asarray(jstft.power_spectrogram(jnp.asarray(x), cj))
        else:
            got = tops.log_power_spectrogram(torch.from_numpy(x), ct, eps=log_eps).numpy()
            xla = np.asarray(jstft.log_power_spectrogram(jnp.asarray(x), cj, eps=log_eps))
        kern = np.asarray(_interpret_reference(jnp.asarray(x), cj, log_eps))
        assert got.shape == kern.shape == xla.shape
        for want in (kern, xla):
            if log_eps is None:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
                continue
            np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=1e-4, atol=1e-6)
            resolved = np.exp(want) > 1e-6 * np.exp(want).max()
            assert resolved.mean() > 0.99
            np.testing.assert_allclose(got[resolved], want[resolved], rtol=1e-4, atol=1e-4)
    assert stft_power.launches == before  # CPU tensors take the plain version


@pytest.mark.parametrize("n", [1, 2, 100, 512, 513, 700, 1500])
def test_center_reflect_pad_of_short_signals_matches_jax(n):
    """A signal of nfft/2 samples or fewer is reflected again and again, as
    jnp.pad / np.pad do (torch's own reflect pad raises there)."""
    ct, cj = tstft.StftConfig(center=True), jstft.StftConfig(center=True)
    x = _signal(n, n)[None]
    got = tstft.pad_signal(torch.from_numpy(x), ct).numpy()
    want = np.asarray(jstft._apply_center_pad(
        jstft._apply_end_pad(jnp.asarray(x), n, cj), cj))
    np.testing.assert_array_equal(got, want)
    if n > 1:
        t = x.shape[-1] + (tstft.padded_length(n, ct) - n)
        np.testing.assert_array_equal(got, np.pad(np.pad(x, ((0, 0), (0, t - n))),
                                                  ((0, 0), (512, 512)), mode="reflect"))
    np.testing.assert_allclose(
        tops.power_spectrogram(torch.from_numpy(x), ct).numpy(),
        np.asarray(jstft.power_spectrogram(jnp.asarray(x), cj)), rtol=1e-4, atol=1e-6)


def test_builder_frames_match_jax_builder_core():
    """build_frames against build_frame_dataset's per-utterance core: peak
    normalization, |STFT|^2 of each utterance alone (its own end pad), the
    trim, and the float32-sum / float64-square-sum statistics."""
    assert DEFAULT_STFT == tstft.StftConfig(center=False) and not J_DEFAULT_STFT.center
    rng = np.random.default_rng(7)
    wavs = [rng.standard_normal(n) * s for n, s in
            ((16000, 0.1), (_quirk_length(), 0.5), (11111, 2.0))]
    trims = [1000, 20, 1000]
    got = build_frames(wavs, max_frames=trims, device="cpu")

    specs, n_sum, s_sum, sq_sum = [], 0, 0.0, 0.0
    for w, m in zip(wavs, trims):
        speech = w / np.max(np.abs(w))
        spec = np.asarray(jstft.power_spectrogram(
            jnp.asarray(speech, jnp.float32), J_DEFAULT_STFT)).T
        spec = spec[:, :min(spec.shape[1], m)]
        specs.append(spec.T)
        n_sum += spec.shape[1]
        s_sum = s_sum + spec.sum(axis=1)
        sq_sum = sq_sum + (spec.astype(np.float64) ** 2).sum(axis=1)
    mean = s_sum / n_sum
    std = j_empirical_std(sq_sum, mean, n_sum)

    assert got.counts == [s.shape[0] for s in specs] and got.counts[1] == 20
    want_x = np.concatenate(specs)
    np.testing.assert_allclose(got.x, want_x, rtol=1e-4, atol=1e-6 * want_x.max())
    assert got.mean.shape == got.std.shape == (513, 1) and got.mean.dtype == np.float32
    np.testing.assert_allclose(got.mean[:, 0], mean, rtol=1e-4)
    np.testing.assert_allclose(got.std[:, 0], std, rtol=1e-4)


@pytest.mark.parametrize("center", [False, True], ids=["nocenter", "center"])
def test_builder_one_batch_gives_each_utterance_its_own_frames(center):
    """build_frames frames every utterance in one batch zero-padded to the
    longest; each keeps exactly the frames it gives alone (its own end pad,
    and its own reflect pad when centred), at the plain version's rounding."""
    cfg = tstft.StftConfig(center=center)
    rng = np.random.default_rng(8)
    lengths = [_quirk_length(), 16000, 11111] + ([300] if center else [])
    wavs = [rng.standard_normal(n) for n in lengths]
    got = build_frames(wavs, cfg, device="cpu")
    alone = [tops.power_spectrogram(
        torch.from_numpy((w / np.abs(w).max()).astype(np.float32)), cfg).numpy() for w in wavs]
    assert got.counts == [a.shape[0] for a in alone]
    want = np.concatenate(alone)
    np.testing.assert_allclose(got.x, want, rtol=1e-5, atol=1e-6 * want.max())
