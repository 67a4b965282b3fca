"""Port parity: the audio-VAD LSTM, its training step, the utterance
batcher, the sequence loop and the wav I/O.

The LSTM forward from converted Flax weights agrees to 1e-5 (rtol and
atol): the same f32 gate products summed in another order. One Adam step
(lr 1e-3) from the same weights on the same batch agrees in its metrics to
rtol 1e-5 and parameter by parameter to 2e-5 absolute, 2% of the step:
Adam's first step is lr g / (|g| + 1e-8), so where a gradient is itself
~1e-8 its last-digit difference moves the update by up to a percent of lr.
``batch_utterances`` reads the same wav and label-h5 files as the JAX
batcher: labels and masks agree exactly; power to rtol 1e-4 above a floor
of 1e-6 of the batch's peak power, and log power to 1e-4 on the bins above
that floor (the bounds ``chip_smoke.py`` holds the kernel to; these
peak-normalized tones put f32 rounding of ~1e-5 into every bin).
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvae_tpu.data.datasets import UtteranceDataset as JaxUtteranceDataset
from dvae_tpu.data.io import pcm16 as jpcm16
from dvae_tpu.data.io import read_wav as jread_wav
from dvae_tpu.models.lstm_vad import LSTMVad as JaxLSTMVad
from dvae_tpu.ops.stft import StftConfig as JaxStftConfig
from dvae_tpu.ops.stft import n_stft_frames
from dvae_tpu.train.sequence import batch_utterances as jbatch_utterances
from dvae_tpu.train.sequence import make_lstm_vad_eval as jmake_eval
from dvae_tpu.train.sequence import make_lstm_vad_step as jmake_step
from dvae_tpu.train.steps import adam as jadam
from dvae_tpu.train.steps import init_train_state
from dvae_tpu_torch.data.datasets import UtteranceDataset
from dvae_tpu_torch.data.io import pcm16, read_wav, write_wav
from dvae_tpu_torch.models import LSTMVad
from dvae_tpu_torch.models.convert import lstm_vad_state_dict_from_jax, state_dict_from_jax
from dvae_tpu_torch.ops import stft_power
from dvae_tpu_torch.ops.stft import StftConfig
from dvae_tpu_torch.train import checkpoint as tckpt
from dvae_tpu_torch.train.sequence import (
    batch_utterances,
    fit_sequence,
    make_lstm_vad_eval,
    make_lstm_vad_predict,
    make_lstm_vad_step,
)
from dvae_tpu_torch.train.steps import adam
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

X_DIM, HIDDEN = 20, 32


@pytest.fixture(scope="module")
def flax_lstm():
    jm = JaxLSTMVad(x_dim=X_DIM, hidden=HIDDEN, num_layers=2)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((2, 5, X_DIM)))
    return jm, params


def _seq_batch(seed=0, b=3, t=40):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, X_DIM)).astype(np.float32)
    y = (rng.uniform(size=(b, t)) > 0.5).astype(np.float32)
    mask = np.zeros((b, t), np.float32)
    for i, n in enumerate((t, 25, 7)[:b]):
        mask[i, :n] = 1.0
    return x, y, mask


def test_lstm_forward_matches_flax(flax_lstm):
    jm, params = flax_lstm
    tm = LSTMVad(X_DIM, HIDDEN, 2)
    tm.load_state_dict(lstm_vad_state_dict_from_jax(params), strict=True)
    x, _, _ = _seq_batch()
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape[:2]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the Dense-only converter cannot express the LSTM tree and says so
    with pytest.raises(ValueError, match="array leaves"):
        state_dict_from_jax(params)
    with pytest.raises(ValueError, match="not an LSTMVad"):
        lstm_vad_state_dict_from_jax({"params": {"head": params["params"]["head"]}})


@pytest.mark.parametrize("use_norm", [False, True], ids=["nonorm", "norm"])
def test_lstm_vad_step_matches_jax(flax_lstm, use_norm):
    jm, params = flax_lstm
    x, y, mask = _seq_batch(1)
    rng = np.random.default_rng(2)
    norm = None
    if use_norm:
        norm = (rng.standard_normal((X_DIM, 1)).astype(np.float32),
                rng.uniform(0.5, 2.0, (X_DIM, 1)).astype(np.float32))
    tx = jadam(1e-3)
    jstate, jm_metrics = jmake_step(jm, tx, norm=norm)(
        init_train_state(jm, params, tx), *map(jnp.asarray, (x, y, mask)))

    tm = LSTMVad(X_DIM, HIDDEN, 2)
    tm.load_state_dict(lstm_vad_state_dict_from_jax(params), strict=True)
    opt = adam(tm.parameters(), 1e-3)
    metrics = make_lstm_vad_step(tm, opt, norm=norm)(*map(torch.from_numpy, (x, y, mask)))
    assert set(metrics) == set(jm_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jm_metrics[k]), rtol=1e-5, err_msg=k)
    want = lstm_vad_state_dict_from_jax(jax.device_get(jstate.params))
    for name, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)

    x2, y2, m2 = _seq_batch(3)
    jev = jmake_eval(jm, norm=norm)(jstate.params, *map(jnp.asarray, (x2, y2, m2)))
    tev = make_lstm_vad_eval(tm, norm=norm)(*map(torch.from_numpy, (x2, y2, m2)))
    for k in tev:
        np.testing.assert_allclose(float(tev[k]), float(jev[k]), rtol=1e-5, err_msg=k)
    p = make_lstm_vad_predict(tm, norm=norm)(torch.from_numpy(x2)).numpy()
    mean, std = (0.0, 1.0) if norm is None else (norm[0].reshape(-1), norm[1].reshape(-1))
    want_p = np.asarray(jm.apply(jstate.params, jnp.asarray((x2 - mean) / (std + 1e-8))))
    np.testing.assert_allclose(p, want_p, rtol=1e-5, atol=1e-5)


def _write_utterances(tmp_path, lengths, label_delta):
    """wav files and per-utterance label h5s ('Y' (1, frames)) for both
    packages' UtteranceDataset."""
    rng = np.random.default_rng(4)
    cfg = JaxStftConfig(center=True)
    pairs = []
    for i, (n, d) in enumerate(zip(lengths, label_delta)):
        t = np.arange(n) / 16000.0
        w = 0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t) + 0.1 * rng.standard_normal(n)
        wav, lab = tmp_path / f"u{i}.wav", tmp_path / f"u{i}_vad.h5"
        write_wav(wav, w / np.abs(w).max() * 0.9, 16000)
        n_lab = max(0, n_stft_frames(n, cfg) + d)
        with h5py.File(lab, "w") as f:
            f.create_dataset("Y", data=(rng.uniform(size=(1, n_lab)) > 0.5).astype(np.float32))
        pairs.append((str(wav), str(lab)))
    return pairs


def test_batch_utterances_matches_jax(tmp_path):
    # labels longer than, shorter than and equal to the frames; one wav of
    # fewer than nfft/2 samples (repeated reflection)
    pairs = _write_utterances(tmp_path, (16000, 9000, 300, 12000), (3, -5, 0, -1000))
    jds, tds = JaxUtteranceDataset(pairs), UtteranceDataset(pairs)
    for i in range(len(pairs)):
        (jw, jy), (tw, ty) = jds[i], tds[i]
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(ty, jy)
    idx = [0, 1, 2, 3]
    js, jy, jm = (np.asarray(a) for a in jbatch_utterances(jds, idx, JaxStftConfig(center=True)))
    before = stft_power.launches
    ts, ty, tm = (a.numpy() for a in batch_utterances(tds, idx, StftConfig(center=True),
                                                      device="cpu"))
    assert stft_power.launches == before
    assert ts.shape == js.shape and ts.shape[1] % 64 == 0
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tm, jm)
    assert tm[3].sum() == 0  # zero-length labels: a fully masked row
    p = np.exp(js)
    resolved = p > 1e-6 * p.max()
    np.testing.assert_allclose(ts[resolved], js[resolved], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.exp(ts), p, rtol=1e-4, atol=1e-6 * p.max())


def _memory_utterances(n, seed):
    """(wav, labels) pairs in memory: any such sequence is a dataset."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(4000, 9000))
        w = (0.3 * rng.standard_normal(m)).astype(np.float32)
        frames = n_stft_frames(m, JaxStftConfig(center=True))
        out.append((w, (rng.uniform(size=frames) > 0.5).astype(np.float32)))
    return out


def test_fit_sequence_resume_is_bitwise(tmp_path):
    cfg = StftConfig(center=True)
    train, valid = _memory_utterances(7, 0), _memory_utterances(3, 1)

    def batcher(ds, idx):
        return batch_utterances(ds, idx, cfg, device="cpu")

    def run(model_dir, start, end):
        tm = LSTMVad(513, 16, 1, generator=torch.Generator().manual_seed(0))
        opt = adam(tm.parameters(), 1e-3)
        hist = fit_sequence(tm, opt, make_lstm_vad_step(tm, opt), make_lstm_vad_eval(tm),
                            train, valid, batcher, model_dir, prefix="VAD",
                            start_epoch=start, end_epoch=end, batch_size=3, log=lambda m: None)
        return tm, hist

    full, hist = run(tmp_path / "full", 1, 4)
    assert [h["epoch"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["train"]["bce"]) and np.isfinite(h["valid"]["bce"]) for h in hist)
    assert len(tckpt.checkpoints(tmp_path / "full", "VAD_epoch_*.pt")) == 3
    run(tmp_path / "part", 1, 3)
    resumed, hist_r = run(tmp_path / "part", 3, 4)
    assert hist_r[0] == hist[2]
    for k, v in full.state_dict().items():
        assert torch.equal(v, resumed.state_dict()[k]), k
    with pytest.raises(NotImplementedError, match="A14"):
        fit_sequence(full, None, None, None, train, valid, batcher, tmp_path, prefix="VAD",
                     mesh=object())


def test_wav_io_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 1000), [0.5 / 32768, 1.5 / 32768, -1.0, 1.0]])
    np.testing.assert_array_equal(pcm16(x), jpcm16(x))
    path = tmp_path / "a.wav"
    write_wav(path, x, 16000)
    got, fs = read_wav(path)
    want, jfs = jread_wav(path)
    assert fs == jfs == 16000 and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
