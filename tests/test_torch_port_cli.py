"""The port's ``python -m dvae_tpu_torch.cli.enhance_wav`` on the CPU.

A temporary tree of short PCM16 wavs (two with the same stem in different
directories) and ``.pt`` checkpoints saved from port models: m1, m2 with
``--y-source npy`` and v5 with ``--y-source self-soft``, at h_dim (32, 32)
and a tiny MCEM budget. Checked: the flat output names with their
duplicate-stem suffix, output lengths, the Wiener partition s + n = x on
the samples the frames cover (away from the ISTFT's edges, to 3 LSB of
PCM16: each of the two outputs and the input is rounded to the grid once),
resume-by-skip, and the argument errors.
"""

import numpy as np
import pytest
import torch

from dvae_tpu_torch.cli import enhance_wav
from dvae_tpu_torch.data.io import read_wav, write_wav
from dvae_tpu_torch.models import CVAE, VAE, DisentangledVAE
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped, samples_for_frames
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

BUDGET = ["--niter", "2", "--nsamples-e-step", "1", "--burnin-e-step", "1",
          "--nsamples-wf", "1", "--burnin-wf", "1", "--h-dim", "32", "32"]
LENGTHS = {"a/x.wav": 9000, "b/x.wav": 12345, "a/long.wav": 16000}
MODELS = {"m1": lambda: VAE(513, 16, (32, 32)), "m2": lambda: CVAE(513, 1, 16, (32, 32)),
          "v5": lambda: DisentangledVAE(513, 1, 16, (32, 32))}


@pytest.fixture
def tree(tmp_path):
    rng = np.random.default_rng(0)
    for rel, n in LENGTHS.items():
        p = tmp_path / "in" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        t = np.arange(n) / 16000
        write_wav(p, 0.3 * np.sin(2 * np.pi * 200 * t) + 0.05 * rng.standard_normal(n), 16000)
        frames = n_stft_frames_clamped(n, StftConfig())
        np.save(p.with_name(p.stem + "_y.npy"), (rng.uniform(size=frames + 2) > 0.5)
                .astype(np.float32))
    for family, make in MODELS.items():
        torch.manual_seed(1)
        torch.save(make().state_dict(), tmp_path / f"{family}.pt")
    return tmp_path


def run(tree, family, *extra):
    enhance_wav.main([str(tree / "in"), "--checkpoint", str(tree / f"{family}.pt"),
                      "--model-class", family, "--output-dir", str(tree / "out"),
                      "--platform", "cpu", *BUDGET, *extra])


def test_enhance_wav_data_parallel_is_the_unsharded_run(tree):
    """``--data-parallel`` shards each batch over ``make_mesh()`` (one CPU
    shard here): the same wavs, bit for bit."""
    run(tree, "m1")
    plain = {p.relative_to(tree / "out"): p.read_bytes() for p in (tree / "out").rglob("*.wav")}
    for p in (tree / "out").rglob("*.wav"):
        p.unlink()
    run(tree, "m1", "--data-parallel")
    assert plain and plain == {p.relative_to(tree / "out"): p.read_bytes()
                               for p in (tree / "out").rglob("*.wav")}


@pytest.mark.parametrize("family,source", [("m1", None), ("m2", "npy"), ("v5", "self-soft")])
def test_enhance_wav_writes_the_wiener_split(tree, capsys, family, source):
    run(tree, family, *(["--y-source", source] if source else []))
    out = tree / "out"
    # files are gathered per directory in sorted order: a/long, a/x, b/x
    want = {"long": 16000, "x": 9000, "x_2": 12345}
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{stem}_{kind}_est.wav" for stem in want for kind in "sn")
    inputs = {"long": "a/long.wav", "x": "a/x.wav", "x_2": "b/x.wav"}
    nfft = StftConfig().nfft
    for stem, n in want.items():
        x, _ = read_wav(tree / "in" / inputs[stem])
        s, fs = read_wav(out / f"{stem}_s_est.wav")
        nn, _ = read_wav(out / f"{stem}_n_est.wav")
        assert fs == 16000 and len(s) == len(nn) == n
        cover = samples_for_frames(n_stft_frames_clamped(n, StftConfig()), StftConfig())
        core = slice(nfft, min(n, cover) - nfft)
        np.testing.assert_allclose((s + nn)[core], x[core], atol=3 / 32768)
        assert np.abs(s[core]).max() > 1e-3  # not all routed to the noise
    said = capsys.readouterr().out
    assert "done: 3 files" in said

    # resume-by-skip: a second run enhances nothing and leaves the files
    stamps = {p.name: p.stat().st_mtime_ns for p in out.iterdir()}
    run(tree, family, *(["--y-source", source] if source else []))
    assert "skipped 3 already-enhanced files" in capsys.readouterr().out
    assert stamps == {p.name: p.stat().st_mtime_ns for p in out.iterdir()}


@pytest.mark.parametrize("args,message", [
    (["--model-class", "m2", "--y-source", "self-soft"], "m2 has no classifier"),
    (["--model-class", "m2v2"], "m2v2 has no classifier"),
    (["--chunk-seconds", "2", "--chunk-overlap", "1.5"], "at most half the chunk"),
    (["--chunk-seconds", "2", "--chunk-concurrency", "0"], "--chunk-concurrency must be >= 1"),
    (["--engine", "gibbs"], "invalid choice: 'gibbs'"),
    # the parser takes --data-parallel (enhancing under it:
    # test_enhance_wav_data_parallel_is_the_unsharded_run)
    (["--data-parallel", "--chunk-seconds", "2", "--chunk-overlap", "1.5"],
     "at most half the chunk"),
    (["--std-norm"], "--std-norm requires --norm-h5"),
    ([], "need --checkpoint or --model-dir"),
])
def test_enhance_wav_argument_errors(tmp_path, capsys, args, message):
    ckpt = [] if not args else ["--checkpoint", str(tmp_path / "none.pt")]
    with pytest.raises(SystemExit) as e:
        enhance_wav.main([str(tmp_path), *ckpt, "--platform", "cpu", *args])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("family,source", [("m1", None), ("v5", "self-soft"), ("m2", "npy")])
def test_enhance_wav_chunked_writes_the_wiener_split(tmp_path, capsys, family, source):
    """--chunk-seconds: a 2.7 s file in 0.5 s chunks, two per dispatch;
    s + n = x over the whole file, across the cross-faded seams."""
    rng = np.random.default_rng(3)
    n = int(2.7 * 16000)
    t = np.arange(n) / 16000
    (tmp_path / "in").mkdir()
    write_wav(tmp_path / "in" / "long.wav",
              0.3 * np.sin(2 * np.pi * 200 * t) + 0.05 * rng.standard_normal(n), 16000)
    np.save(tmp_path / "in" / "long_y.npy", (rng.uniform(size=n // 256 + 8) > 0.5)
            .astype(np.float32))
    torch.manual_seed(1)
    torch.save(MODELS[family]().state_dict(), tmp_path / f"{family}.pt")
    enhance_wav.main([str(tmp_path / "in"), "--checkpoint", str(tmp_path / f"{family}.pt"),
                      "--model-class", family, "--output-dir", str(tmp_path / "out"),
                      "--platform", "cpu", *BUDGET, "--chunk-seconds", "0.5",
                      "--chunk-overlap", "0.1", "--chunk-concurrency", "2",
                      *(["--y-source", source] if source else [])])
    x, _ = read_wav(tmp_path / "in" / "long.wav")
    s, fs = read_wav(tmp_path / "out" / "long_s_est.wav")
    nn, _ = read_wav(tmp_path / "out" / "long_n_est.wav")
    assert fs == 16000 and len(s) == len(nn) == n
    nfft = StftConfig().nfft
    np.testing.assert_allclose((s + nn)[nfft:-nfft], x[nfft:-nfft], atol=3 / 32768)
    assert np.abs(s).max() > 1e-3
    assert "done: 1 files" in capsys.readouterr().out


def test_enhance_wav_fails_fast_on_inputs(tree):
    """A wrong sample rate or a missing label file stops the run before any
    output is written."""
    write_wav(tree / "in" / "b" / "slow.wav", np.zeros(8000), 8000)
    with pytest.raises(SystemExit, match="8000 Hz != model rate 16000 Hz"):
        run(tree, "m1")
    (tree / "in" / "b" / "slow.wav").unlink()
    (tree / "in" / "a" / "long_y.npy").unlink()
    with pytest.raises(SystemExit, match="long_y.npy not found"):
        run(tree, "m2", "--y-source", "npy")
    assert not (tree / "out").exists()
    with pytest.raises(SystemExit, match="export_torch_checkpoint"):
        enhance_wav.main([str(tree / "in"), "--checkpoint", str(tree / "m1.msgpack"),
                          "--output-dir", str(tree / "out"), "--platform", "cpu"])


def test_enhance_wav_defaults_to_the_card(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enhance_wav.main([str(tree / "in"), "--checkpoint", str(tree / "m1.pt"),
                          "--output-dir", str(tree / "out")])
    assert not (tree / "out").exists()
