"""The STFT power kernel's FFT decomposition, modelled in numpy on the CPU.

``csrc/stft_power.cu`` takes each frame's real FFT as a complex FFT of
half the size: it packs z[m] = xw[2m] + i xw[2m+1], runs the Stockham
passes of ``stft_power.fft_plan`` (radix-8 DFTs, then a radix-4 or
radix-2 pass), splits the result into the nfft/2 + 1 real-input bins and
squares them (and takes the log). ``_kernel_model`` does the same steps in
the same order, in float32, on the f32 tables of ``fft_tables_np``. It is
held against float64 numpy, against the port's plain version (the matmul
DFT) and against the JAX Pallas kernel in interpret mode, at the
tolerances of ``tests/test_torch_port_stft_power.py``: power to rtol 1e-4
above a floor of 1e-6 of the peak, log power to 1e-4 on the bins above
1e-6 of the peak. The kernel itself is held against the plain version on
the card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvae_tpu.ops.pallas_stft import _interpret_reference
from dvae_tpu_torch.ops import stft as tstft
from dvae_tpu_torch.ops import stft_power
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

jstft = importlib.import_module("dvae_tpu.ops.stft")

RSQRT2 = np.float32(np.sqrt(0.5))


def _dft(v):
    """The kernel's in-register R-point DFTs (``dft<R>``), on lists of
    complex64 arrays."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        c0, c1, c2 = v[0] + v[2], v[0] - v[2], v[1] + v[3]
        d = v[1] - v[3]
        c3 = d.imag - 1j * d.real  # times -i
        return [c0 + c2, c1 + c3, c0 - c2, c1 - c3]
    e = [v[r] + v[r + 4] for r in range(4)]
    o = [v[r] - v[r + 4] for r in range(4)]
    o[1] = RSQRT2 * (o[1].real + o[1].imag) + 1j * (RSQRT2 * (o[1].imag - o[1].real))
    o[2] = o[2].imag - 1j * o[2].real
    o[3] = RSQRT2 * (o[3].imag - o[3].real) - 1j * (RSQRT2 * (o[3].real + o[3].imag))
    e, o = _dft(e), _dft(o)
    return [x for q in range(4) for x in (e[q], o[q])]


def _complex(pairs):
    return (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64)


def _kernel_model(frames, nfft, log_eps=None, window="hann"):
    """(F, nfft) float32 frames -> (F, nfft/2 + 1) float32, step by step as
    the kernel computes them."""
    win, tw, split = stft_power.fft_tables_np(nfft, window)
    tw, split = _complex(tw), _complex(split)
    n = nfft // 2
    xw = frames.astype(np.float32) * win
    buf = (xw[:, 0::2] + 1j * xw[:, 1::2]).astype(np.complex64)  # pack
    off = 0
    for r_, ns in stft_power.fft_plan(nfft):
        j = np.arange(n // r_)
        v = [buf[:, j + r * (n // r_)] for r in range(r_)]
        if ns > 1:  # the first pass has no twiddles
            v = [v[0]] + [v[r] * tw[off + (r - 1) * ns + j % ns] for r in range(1, r_)]
            off += (r_ - 1) * ns
        out = np.empty_like(buf)
        for r, vr in enumerate(_dft(v)):
            out[:, (j // ns) * ns * r_ + j % ns + r * ns] = vr
        buf = out
    assert off == len(tw)
    k = np.arange(n // 2 + 1)
    a, b = buf[:, k], buf[:, (n - k) % n]
    h = np.float32(0.5)
    e = h * (a.real + b.real) + 1j * (h * (a.imag - b.imag))
    o = h * (a.imag + b.imag) - 1j * (h * (a.real - b.real))
    t = split[k] * o.astype(np.complex64)
    lo, hi = e.astype(np.complex64) + t, e.astype(np.complex64) - t
    p = np.empty((frames.shape[0], n + 1), np.float32)
    p[:, k] = lo.real * lo.real + lo.imag * lo.imag
    p[:, n - k[:-1]] = (hi.real * hi.real + hi.imag * hi.imag)[:, :-1]
    if log_eps is not None:
        p = np.log(p + np.float32(log_eps))
    return p


def _frames(x, cfg):
    xp = tstft.pad_signal(torch.from_numpy(x), cfg)
    return tstft.frame_signal(xp, cfg.nfft, cfg.hop).reshape(-1, cfg.nfft).numpy()


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * rng.standard_normal(n)).astype(np.float32)


def _assert_power_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * want.max())


def _wavefronts(idx):
    """(wavefronts, floor) of one warp's float2 access to buffer entries
    ``idx``: the most distinct 4-byte words in any of the 32 banks, and
    the least any placement could give."""
    words = np.unique(np.stack([2 * idx, 2 * idx + 1], -1))
    return np.bincount(words % 32, minlength=32).max(), -(-words.size // 32)


def _buffer_wavefronts(nfft, place):
    """Summed (wavefronts, floor) of every buffer access one frame makes
    in the kernel, lane j of a warp holding butterflies j, j + 32, ...:
    each pass's reads (the first reads the waveform instead) and writes,
    then the split's reads of Z[k] and Z[N - k]."""
    n, out = nfft // 2, np.zeros(2, int)
    for r_, ns in stft_power.fft_plan(nfft):
        nb = n // r_
        for p in range(-(-nb // 32)):
            j = np.arange(32 * p, min(32 * p + 32, nb))
            for r in range(r_):
                if ns > 1:
                    out += _wavefronts(place(j + r * nb))
                out += _wavefronts(place((j // ns) * ns * r_ + j % ns + r * ns))
    for i in range(n // 64 + 1):
        k = np.arange(32 * i, min(32 * i + 32, n // 2 + 1))
        out += np.add(_wavefronts(place(k)), _wavefronts(place((n - k) % n)))
    return out


@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048])
def test_buffer_swizzle_spreads_banks(nfft):
    """The kernel keeps buffer entry i at i ^ ((i >> 3) & 15), a permutation
    within each group of 16: its passes and split then take at most 5%
    more shared-memory wavefronts than the floor, where the entries in
    order take 1.9 times the floor or more."""
    n = nfft // 2
    swizzle = lambda i: i ^ ((i >> 3) & 15)  # noqa: E731
    np.testing.assert_array_equal(np.sort(swizzle(np.arange(n))), np.arange(n))
    got, floor = _buffer_wavefronts(nfft, swizzle)
    in_order, _ = _buffer_wavefronts(nfft, lambda i: i)
    assert got <= 1.05 * floor and in_order >= 1.9 * floor


@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048])
def test_tables_match_float64(nfft):
    """Window, Stockham twiddles and split twiddles are float64 values
    rounded to float32, each where the kernel reads it."""
    win, tw, split = stft_power.fft_tables_np(nfft, "hann")
    assert win.dtype == tw.dtype == split.dtype == np.float32
    n = nfft // 2
    np.testing.assert_array_equal(win, tstft.get_window("hann", nfft).astype(np.float32))
    powers = np.concatenate([(np.arange(1, r)[:, None] * np.arange(ns)[None, :]).ravel()
                             * (n // (ns * r)) for r, ns in stft_power.fft_plan(nfft) if ns > 1])
    for table, exact in ((tw, np.exp(-2j * np.pi * powers / n)),
                         (split, np.exp(-2j * np.pi * np.arange(n) / nfft))):
        np.testing.assert_array_equal(table, np.stack([exact.real, exact.imag], -1)
                                      .astype(np.float32))
        assert np.abs(table[:, 0] + 1j * table[:, 1] - exact).max() < 2 ** -24


@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048])
def test_model_matches_float64_rfft(nfft):
    plan = stft_power.fft_plan(nfft)
    assert np.prod([r for r, _ in plan]) == nfft // 2
    assert all(r == 8 for r, _ in plan[:-1]) and plan[-1][0] in (2, 4, 8)
    rng = np.random.default_rng(nfft)
    frames = (rng.standard_normal((6, nfft)) * np.array([1e-3, 0.1, 1, 1, 10, 1e3])[:, None]
              ).astype(np.float32)
    want = np.abs(np.fft.rfft(frames.astype(np.float64)
                              * tstft.get_window("hann", nfft), axis=-1)) ** 2
    got = _kernel_model(frames, nfft)
    for g, w in zip(got, want):  # each row against its own peak
        _assert_power_close(g, w)


@pytest.mark.parametrize("log_eps", [None, 1e-12], ids=["power", "log"])
@pytest.mark.parametrize("center", [False, True], ids=["nocenter", "center"])
def test_model_matches_plain_and_pallas_interpreter(center, log_eps):
    ct, cj = tstft.StftConfig(center=center), jstft.StftConfig(center=center)
    # the fewest frames a signal gives: one uncentred; two centred, where the
    # end pad always adds a hop to a signal this short
    short = 200 if center else 769
    assert tstft.n_stft_frames(short, ct) == (2 if center else 1)
    cases = [np.stack([_signal(9000, 3), _signal(9000, 4)]),
             np.zeros((1, 5000), np.float32),                        # silence
             np.where(_signal(6000, 5) > 0, 1.0, -1.0).astype(np.float32)[None],  # full scale
             _signal(short, 6)[None]]
    for x in cases:
        got = _kernel_model(_frames(x, ct), ct.nfft, log_eps).reshape(
            *x.shape[:-1], -1, ct.n_bins)
        plain_power = stft_power.stft_power_reference(torch.from_numpy(x), ct).numpy()
        kern = np.asarray(_interpret_reference(jnp.asarray(x), cj, log_eps))
        assert got.shape == plain_power.shape == kern.shape
        if log_eps is None:
            for want in (plain_power, kern):
                _assert_power_close(got, want)
            continue
        plain = stft_power.stft_power_reference(torch.from_numpy(x), ct, log_eps).numpy()
        # bins at or above 1e-6 of the peak power (all of them in silence)
        resolved = plain_power >= 1e-6 * plain_power.max()
        assert resolved.mean() > 0.99
        for want in (plain, kern):
            np.testing.assert_allclose(got[resolved], want[resolved], rtol=1e-4, atol=1e-4)
        if not x.any():  # silence: every bin is log(eps), as the plain version gives it
            np.testing.assert_allclose(got, plain, rtol=1e-7)
            np.testing.assert_allclose(got, np.log(np.float32(log_eps)), rtol=1e-7)


def test_check_framing_needs_no_library(monkeypatch):
    def no_library(_):
        raise AssertionError("the framing check built the library")

    monkeypatch.setattr(stft_power, "load_library", no_library)
    check = stft_power._check_framing.__wrapped__
    for nfft, hop in ((1024, 256), (1024, 251), (1024, 1), (256, 64), (2048, 512)):
        check(nfft, hop)
    assert tstft.StftConfig(wlen_sec=0.025).nfft == 400  # a 25 ms window
    for nfft, hop, match in ((400, 100, "nfft"), (4096, 1024, "nfft"), (1000, 250, "nfft"),
                             (1024, 0, "hop"), (1024, 100_000, "shared memory")):
        with pytest.raises(ValueError, match=match):
            check(nfft, hop)
