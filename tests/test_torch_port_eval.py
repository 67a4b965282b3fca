"""Port parity: the scorers and the statistics tables against the JAX
package's, on the same numpy arrays made from a seed.

The port's ``eval/si_sdr.py``, ``stoi.py``, ``pesq_native.py`` and
``stats.py`` are copies of the JAX package's host numpy modules, so every
score must equal the JAX one bit for bit (``assert_array_equal`` /
``==``; the statistics tables and ``stats.json`` compare equal as dicts).
The PESQ dispatcher is held without the licensed wheel (``pesq`` blocked
from import), the POLQA gate without ``uhh_sp``. Signals are 1-3 s at
16 kHz (8 kHz for one narrowband case), so every test stays well inside
the fast tier's time per test.
"""

import json
import sys

import numpy as np
import pytest

import dvae_tpu.eval as jeval
import dvae_tpu.eval.pesq as jpesq
import dvae_tpu.eval.pesq_native as jpesq_native
import dvae_tpu_torch.eval as teval
import dvae_tpu_torch.eval.pesq as tpesq
import dvae_tpu_torch.eval.pesq_native as tpesq_native
from dvae_tpu.data.io import read_wav as jax_read_wav
from dvae_tpu_torch.data.io import write_wav
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

FS = 16000


def speechlike(rng, seconds, fs=FS):
    """A harmonic tone with a drifting pitch, switched on and off (so that
    STOI's silent-frame removal and PESQ's activity gate both act)."""
    n = int(seconds * fs)
    t = np.arange(n) / fs
    f0 = 120 + 40 * rng.random() + 15 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / fs
    s = sum(np.sin(k * phase) / k for k in range(1, 9))
    return 0.3 * s * (np.sin(2 * np.pi * 1.3 * t) > -0.4)


@pytest.fixture(scope="module")
def signals():
    """(clean, degraded) pairs at 16 kHz: light and heavy white noise, a
    delayed copy, and a 1 s pair."""
    rng = np.random.default_rng(0)
    s2, s1 = speechlike(rng, 2.0), speechlike(rng, 1.0)
    return {
        "light": (s2, s2 + 0.01 * rng.standard_normal(len(s2))),
        "heavy": (s2, s2 + 0.2 * rng.standard_normal(len(s2))),
        "delayed": (s2, np.concatenate([np.zeros(40), s2[:-40]])
                    + 0.02 * rng.standard_normal(len(s2))),
        "short": (s1, s1 + 0.05 * rng.standard_normal(len(s1))),
    }


def test_exports_match_the_jax_package():
    assert teval.__all__ == jeval.__all__


@pytest.mark.parametrize("case", ["light", "heavy", "delayed", "short"])
def test_si_sdr_family_is_bitwise_jax(signals, case):
    s, s_hat = signals[case]
    n = s_hat - s
    for a, b in zip(teval.si_sdr_components(s_hat, s, n), jeval.si_sdr_components(s_hat, s, n)):
        np.testing.assert_array_equal(a, b)
    assert teval.energy_ratios(s_hat, s, n) == jeval.energy_ratios(s_hat, s, n)
    assert teval.si_sdr_leroux(s_hat, s) == jeval.si_sdr_leroux(s_hat, s)


@pytest.mark.parametrize("extended", [True, False], ids=["estoi", "stoi"])
@pytest.mark.parametrize("compat", ["pystoi", "matlab"])
def test_stoi_is_bitwise_jax(signals, extended, compat):
    for case in ("light", "heavy", "short"):
        s, s_hat = signals[case]
        got = teval.stoi(s, s_hat, FS, extended=extended, compat=compat)
        assert got == jeval.stoi(s, s_hat, FS, extended=extended, compat=compat)
        assert 0.0 < got <= 1.0 + 1e-9
    with pytest.raises(ValueError, match="bad compat"):
        teval.stoi(s, s_hat, FS, compat="octave")
    with pytest.raises(ValueError, match="same length"):
        teval.stoi(s, s_hat[:-1], FS)


def test_stoi_of_a_silent_signal_warns_as_jax(recwarn):
    x = np.zeros(FS)
    x[100:400] = 0.1
    assert teval.stoi(x, x, FS) == jeval.stoi(x, x, FS) == 1e-5


@pytest.mark.parametrize("case", ["light", "heavy", "delayed", "short"])
def test_pesq_wb_is_bitwise_jax(signals, case):
    s, s_hat = signals[case]
    got = tpesq_native.pesq_wb(s, s_hat, FS)
    assert got == jpesq_native.pesq_wb(s, s_hat, FS)
    assert 0.999 <= got <= 4.999


def test_pesq_nb_is_bitwise_jax(signals):
    s, s_hat = signals["heavy"]
    # at 16 kHz (resampled to 8 kHz inside) and at 8 kHz
    assert tpesq_native.pesq_nb(s, s_hat, FS) == jpesq_native.pesq_nb(s, s_hat, FS)
    s8, d8 = s[::2], s_hat[::2]
    assert tpesq_native.pesq_nb(s8, d8) == jpesq_native.pesq_nb(s8, d8)
    assert tpesq_native.pesq_wb(s, s, FS) == jpesq_native.pesq_wb(s, s, FS)
    with pytest.raises(ValueError, match="too short"):
        tpesq_native.pesq_wb(s[:300], s_hat[:300], FS)


def test_pesq_dispatcher_without_the_wheel(signals, monkeypatch):
    monkeypatch.setitem(sys.modules, "pesq", None)  # the licensed wheel absent
    s, s_hat = signals["light"]
    assert not tpesq.pesq_wheel_available() and not jpesq.pesq_wheel_available()
    assert tpesq.pesq_available() and jpesq.pesq_available()
    for mode in ("wb", "nb"):
        got = tpesq.pesq(FS, s, s_hat, mode)
        assert got == jpesq.pesq(FS, s, s_hat, mode)
        native = tpesq_native.pesq_wb if mode == "wb" else tpesq_native.pesq_nb
        assert got == native(s, s_hat, FS)
    with pytest.raises(ValueError, match="unknown PESQ mode"):
        tpesq.pesq(FS, s, s_hat, "swb")


def test_polqa_gate_raises_as_jax(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "uhh_sp", None)
    monkeypatch.setitem(sys.modules, "uhh_sp.evaluation", None)
    assert not tpesq.polqa_available() and not jpesq.polqa_available()
    with pytest.raises(RuntimeError, match="uhh_sp") as got:
        tpesq.polqa(["a.wav"], ["b.wav"])
    with pytest.raises(RuntimeError) as want:
        jpesq.polqa(["a.wav"], ["b.wav"])
    assert str(got.value) == str(want.value)


def test_polqa_prepare_pairs_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    pairs = []
    for i, seconds in enumerate((1.0, 3.5, 2.0)):
        d = tmp_path / "in" / "Babble" / "-5" / "test" / f"spk{i}"
        d.mkdir(parents=True)
        ref = 0.3 * rng.standard_normal(int(seconds * FS))
        write_wav(d / "sa1_s.wav", ref, FS)
        write_wav(d / "sa1_s_est.wav", ref + 0.01 * rng.standard_normal(len(ref)), FS)
        pairs.append((str(d / "sa1_s.wav"), str(d / "sa1_s_est.wav")))
    got = tpesq.polqa_prepare_pairs(pairs, str(tmp_path / "port"))
    want = jpesq.polqa_prepare_pairs(pairs, str(tmp_path / "jax"))
    assert got[0] == want[0] == [pairs[1]]
    assert [tuple(p.replace("/port/", "/jax/") for p in pair) for pair in got[1]] == want[1]
    for pair_t, pair_j in zip(got[1], want[1]):
        for a, b in zip(pair_t, pair_j):
            (xa, fa), (xb, fb) = jax_read_wav(a), jax_read_wav(b)
            assert fa == fb == FS and len(xa) == 3 * FS
            np.testing.assert_array_equal(xa, xb)


def test_mean_confidence_interval_is_bitwise_jax():
    rng = np.random.default_rng(5)
    for data in (rng.standard_normal(17), [2.5], rng.random(2)):
        for conf in (0.95, 0.9):
            assert teval.mean_confidence_interval(data, conf) == \
                jeval.mean_confidence_interval(data, conf)


def test_compute_stats_tables_and_json_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    n = 23
    rows = rng.standard_normal((n, 4)).tolist()
    rows[3][3] = float("nan")  # a missing classifier column is excluded
    for r in rows[:5]:
        r[2] = float("nan")  # a group where one metric has no finite value
    keys = ["si_sdr", "estoi", "pesq", "f1"]
    snrs = rng.choice([-5, 0, 5], n)
    noises = rng.choice(["Babble", "Car", "LR"], n).tolist()
    noises[0] = "White"  # a one-utterance group: CI 0
    speakers = [f"spk{i % 4}" for i in range(n)]
    stat = ["Stationary noise" if x in ("Car", "White") else "Nonstationary noise"
            for x in noises]
    said = {"port": [], "jax": []}
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = teval.compute_stats(keys, rows, tmp_path / "port", 0.95, snrs, noises, speakers,
                              stat, out=said["port"].append)
    want = jeval.compute_stats(keys, rows, tmp_path / "jax", 0.95, snrs, noises, speakers,
                               stat, out=said["jax"].append)
    assert got == want and said["port"] == said["jax"]
    assert set(got) == {"overall", "snr_db", "noise_type", "stationarity", "speaker"}
    assert got["noise_type"]["White"]["si_sdr"]["+/-"] == 0.0
    assert (tmp_path / "port" / "stats.json").read_text() == \
        (tmp_path / "jax" / "stats.json").read_text()
    assert json.loads((tmp_path / "port" / "stats.json").read_text()) == got
