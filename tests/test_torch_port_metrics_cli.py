"""Port parity: the scoring CLIs (``run_metrics``, ``run_metrics_classif``)
and the six reconstruct CLIs against the JAX scripts, in process on the
CPU.

A synthetic processed tree (``_ntcd_tree.make_tree``: five utterances, the
subset grid's two mixtures each, ``.h5`` label files) with synthetic
"enhanced" wavs (the clean utterance plus seeded noise) and classifier
label files. Both packages score the same files; the scorers are bitwise
copies and the F1 counts exact, so ``stats.json`` / ``stats_input.json``
are held at rtol 1e-6 (they come out equal). The port also reads the
``.npz`` label files of the same tree with ``h5py`` blocked, to the same
tables. Figures and lip-video demos: the same file names. The reconstruct
CLIs: each JAX script and its port write the same file set (the figure
writer replaced by a recorder that touches each file, in both packages),
with equal wav rows and oracle masks, spectrogram rows at rtol 1e-5 of
each frame's peak and the M2-info classifier's masks at atol 1e-4; the
sampled reconstructions, and ``_recon_aux``'s masks from the sampled
latent, differ by design (``PRNGKey(0)`` against a torch generator) and
are held to their shapes.
"""

import importlib
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.eval.reconstruct as jrec
import dvae_tpu.models as jmodels
from dvae_tpu.train import checkpoint as jckpt
from dvae_tpu_torch.cli import run_metrics, run_metrics_classif
from dvae_tpu_torch.data.io import read_labels, read_wav, write_labels, write_wav
from dvae_tpu_torch.eval import reconstruct as trec
from dvae_tpu_torch.models.convert import state_dict_from_jax
from _ntcd_tree import NOISES, UTTS, make_tree
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
H = (32, 32)


@pytest.fixture
def jax_cache_kept():
    """``--no-jit-cache`` turns the JAX compile cache off for the process:
    put back what the suite had."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def _jax_main(monkeypatch, script, argv):
    sys.path.insert(0, str(SCRIPTS))
    mod = importlib.import_module(script)
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv, "--platform", "cpu",
                                      "--no-jit-cache"])
    return mod.main()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The data root, the enhanced outputs (every mixture but one, also
    under the ``_y_hat_hard`` suffix for two) and a classifier dir: hard
    and soft ``.npy`` per speaker for every utterance but one, a ``.pt``
    for one, and a condition-mirrored file for one mixture (it must win
    over the speaker's file in ``run_metrics``)."""
    root = tmp_path_factory.mktemp("metrics")
    make_tree(root)
    proc = root / "data" / "subset" / "processed"
    rng = np.random.default_rng(1)
    est, clf = root / "est", root / "clf"
    mixtures = [(noise, spk, utt) for noise in NOISES for spk, utt in UTTS]
    for i, (noise, spk, utt) in enumerate(mixtures[:-1]):
        clean, _ = read_wav(proc / "ntcd_timit/Clean/test" / spk / f"{utt}.wav")
        d = est / "ntcd_timit/Noisy" / noise / "-5/test" / spk
        d.mkdir(parents=True, exist_ok=True)
        s_hat = clean + (0.01 + 0.02 * i) * rng.standard_normal(len(clean))
        write_wav(d / f"{utt}_s_est.wav", s_hat, 16000)
        if i < 2:
            write_wav(d / f"{utt}_s_est_y_hat_hard.wav", s_hat[::-1], 16000)
    for j, (spk, utt) in enumerate(list(UTTS)[:-1]):
        label = proc / f"ntcd_timit/Clean/test/{spk}/{utt}_vad_labels_upsampled.h5"
        n = read_labels(label).shape[1]
        d = clf / spk
        d.mkdir(parents=True, exist_ok=True)
        soft = rng.random(n + j - 2).astype(np.float32)
        np.save(d / f"{utt}_y_hat_soft.npy", soft)
        hard = (soft > 0.5).astype(np.float32)
        if j == 1:
            torch.save(torch.from_numpy(hard), d / f"{utt}_y_hat_hard.pt")
        else:
            np.save(d / f"{utt}_y_hat_hard.npy", hard)
    spk, utt = list(UTTS)[0]
    mirrored = clf / "ntcd_timit/Noisy/LR/-5/test" / spk
    mirrored.mkdir(parents=True)
    np.save(mirrored / f"{utt}_y_hat_hard.npy", np.ones(50, np.float32))
    return root


def _stats(path):
    return json.loads(pathlib.Path(path).read_text())


def _close(a, b):
    """Two stats dicts equal, numbers at rtol 1e-6."""
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    else:
        assert a == b


@pytest.mark.parametrize("extra,stats", [
    ([], "stats.json"),
    (["--classifier-dir", "{clf}"], "stats.json"),
    (["--suffix", "_y_hat_hard"], "stats.json"),
    (["--score-input"], "stats_input.json"),
], ids=["plain", "classifier-dir", "suffix", "score-input"])
def test_run_metrics_stats_equal_jax(tree, tmp_path, monkeypatch, capsys, jax_cache_kept,
                                     extra, stats):
    extra = [a.format(clf=tree / "clf") for a in extra]
    out = tmp_path / "out"
    out.mkdir()
    argv = ["--data-root", str(tree / "data"), "--model-output-dir",
            str(tree / "est" if "--score-input" not in extra else out), "--snr", "-5", *extra]
    _jax_main(monkeypatch, "run_metrics", argv)
    want = _stats((out if "--score-input" in extra else tree / "est") / stats)
    said_jax = capsys.readouterr().out
    got = run_metrics.main(argv + ["--platform", "cpu"])
    said = capsys.readouterr().out
    _close(_stats((out if "--score-input" in extra else tree / "est") / stats), want)
    _close(got, want)
    keys = ["si_sdr", "estoi", "pesq"] + (["accuracy", "precision", "recall", "f1"]
                                          if "--classifier-dir" in extra else [])
    assert list(got["overall"]) == keys
    # the two suffixed estimates are both Babble mixtures
    assert set(got["noise_type"]) == ({"Babble"} if "--suffix" in extra else set(NOISES))
    for line in ("missing enhanced output", "missing classifier output"):
        assert (line in said) == (line in said_jax)
    if "--classifier-dir" in extra:
        assert got["overall"]["f1"]["avg"] is not None


def test_run_metrics_classif_stats_equal_jax(tree, tmp_path, monkeypatch, capsys,
                                             jax_cache_kept):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    for extra in ([], ["--label-suffix", "_y_hat_soft", "--binarize", "0.5"]):
        argv = ["--data-root", str(tree / "data"), "--classifier-dir", str(tree / "clf"), *extra]
        _jax_main(monkeypatch, "run_metrics_classif", argv + ["--stats-dir", str(tmp_path / "j")])
        rows = run_metrics_classif.main(argv + ["--stats-dir", str(tmp_path / "t"),
                                                "--platform", "cpu"])
        said = capsys.readouterr().out
        assert "no classifier output" in said
        assert len(rows) == len(UTTS) - 1
        # the port's last line pools every scored frame, as predict_vad_labels does
        assert said.strip().splitlines()[-1].startswith(
            f"pooled over {len(rows)} utterances: accuracy=")
        _close(_stats(tmp_path / "t/stats.json"), _stats(tmp_path / "j/stats.json"))


def _npz_tree(src, dst):
    """``src``'s processed tree with every label file an ``.npz``."""
    import shutil

    shutil.copytree(src / "data", dst / "data")
    for h5 in (dst / "data").rglob("*_labels_upsampled.h5"):
        write_labels(h5.with_suffix(".npz"), read_labels(h5))
        h5.unlink()


def test_scoring_clis_read_npz_labels_without_h5py(tree, tmp_path, monkeypatch):
    (tmp_path / "h5").mkdir()
    (tmp_path / "npz").mkdir()
    ref_rows = run_metrics_classif.main(["--data-root", str(tree / "data"), "--classifier-dir",
                                         str(tree / "clf"), "--stats-dir", str(tmp_path / "h5"),
                                         "--platform", "cpu"])
    ref = run_metrics.main(["--data-root", str(tree / "data"), "--model-output-dir",
                            str(tree / "est"), "--classifier-dir", str(tree / "clf"),
                            "--platform", "cpu"])
    _npz_tree(tree, tmp_path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    rows = run_metrics_classif.main(["--data-root", str(tmp_path / "data"), "--classifier-dir",
                                     str(tree / "clf"), "--stats-dir", str(tmp_path / "npz"),
                                     "--platform", "cpu"])
    assert rows == ref_rows
    assert _stats(tmp_path / "npz/stats.json") == _stats(tmp_path / "h5/stats.json")
    got = run_metrics.main(["--data-root", str(tmp_path / "data"), "--model-output-dir",
                            str(tree / "est"), "--classifier-dir", str(tree / "clf"),
                            "--platform", "cpu"])
    assert got == ref


def _small_tree(root, count):
    utts = dict(list(UTTS.items())[:count])
    make_tree(root, utts=utts)
    proc = root / "data" / "subset" / "processed"
    for noise in NOISES:
        for spk, utt in utts:
            src = proc / "ntcd_timit/Noisy" / noise / "-5/test" / spk / f"{utt}.wav"
            d = root / "est" / src.relative_to(proc).parent
            d.mkdir(parents=True, exist_ok=True)
            x, _ = read_wav(src)
            write_wav(d / f"{utt}_s_est.wav", 0.5 * x, 16000)
    return utts


def test_run_metrics_figures_match_jax_names(tmp_path, monkeypatch, jax_cache_kept):
    pytest.importorskip("matplotlib")
    _small_tree(tmp_path, 1)
    argv = ["--data-root", str(tmp_path / "data"), "--model-output-dir", str(tmp_path / "est"),
            "--with-figures"]
    _jax_main(monkeypatch, "run_metrics", argv)
    want = sorted(p.relative_to(tmp_path) for p in (tmp_path / "est").rglob("*_fig.png"))
    for p in want:
        (tmp_path / p).unlink()
    run_metrics.main(argv + ["--platform", "cpu"])
    got = sorted(p.relative_to(tmp_path) for p in (tmp_path / "est").rglob("*_fig.png"))
    assert got == want and len(got) == len(NOISES)


def test_run_metrics_classif_figures_and_videos_match_jax_names(tmp_path, monkeypatch,
                                                                 jax_cache_kept):
    pytest.importorskip("matplotlib")
    pytest.importorskip("cv2")
    import h5py

    utts = _small_tree(tmp_path, 2)
    proc = tmp_path / "data/subset/processed"
    rng = np.random.default_rng(2)
    for spk, utt in utts:
        label = proc / f"ntcd_timit/Clean/test/{spk}/{utt}_vad_labels_upsampled.h5"
        n = read_labels(label).shape[1]
        d = tmp_path / "clf" / spk
        d.mkdir(parents=True, exist_ok=True)
        soft = rng.random(n).astype(np.float32)
        np.save(d / f"{utt}_y_hat_hard.npy", (soft > 0.5).astype(np.float32))
        np.save(d / f"{utt}_y_hat_soft.npy", soft)
        v = proc / "ntcd_timit/matlab_raw/test" / spk
        v.mkdir(parents=True, exist_ok=True)
        with h5py.File(v / f"{utt}_upsampled.h5", "w") as f:
            f["X"] = rng.uniform(0, 255, (8, 8, n - 2)).astype(np.float32)
    argv = ["--data-root", str(tmp_path / "data"), "--classifier-dir", str(tmp_path / "clf"),
            "--with-figures", "--with-videos"]

    def written():
        return sorted(p.relative_to(tmp_path) for p in (tmp_path / "clf").rglob("*")
                      if p.suffix in (".png", ".mp4"))

    _jax_main(monkeypatch, "run_metrics_classif", argv)
    want = written()
    for p in want:
        (tmp_path / p).unlink()
    run_metrics_classif.main(argv + ["--platform", "cpu"])
    assert written() == want and len(want) == 4 * len(utts)
    assert {p.name.split("_", 1)[1] for p in want} == {
        "y_hat_hard_hard_mask.png", "oracle_audio.mp4", "pred_audio.mp4", "soft_audio.mp4"}


# --------------------------------------------------------------------------
# the six reconstruct CLIs


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """JAX M1, M2 (VAD) and M2-info weights at h_dim (32, 32): a ``.msgpack``
    each for the JAX scripts, the same weights as a ``.pt`` for the port."""
    root = tmp_path_factory.mktemp("recon_models")
    out = {}
    for name, jm, y_dim in (
            ("m1", jmodels.VAE(x_dim=513, z_dim=16, h_dim=H), None),
            ("m2", jmodels.CVAE(x_dim=513, y_dim=1, z_dim=16, h_dim=H), 1),
            ("m2_info", jmodels.DisentangledVAE(x_dim=513, y_dim=1, z_dim=16, h_dim=H), 1)):
        init = [jnp.ones((4, 513))] + ([] if y_dim is None else [jnp.ones((4, y_dim))])
        params = jmodels.init_params(jm, {"params": jax.random.PRNGKey(5),
                                          "sample": jax.random.PRNGKey(6)}, *init)
        msgpack = jckpt.save_checkpoint(root / name, "M_epoch_001_vloss_1.00", params)
        pt = root / name / "M_epoch_001_vloss_1.00.pt"
        torch.save(state_dict_from_jax(params), pt)
        out[name] = (str(msgpack), str(pt))
    return out


@pytest.fixture(scope="module")
def recon_tree(tmp_path_factory, tree):
    """The metrics tree plus a QUT tree of three ``_s/_n/_x.wav`` triplets
    as ``create_test_set`` lays them out."""
    import shutil

    root = tmp_path_factory.mktemp("recon_tree")
    shutil.copytree(tree / "data", root / "data")
    shutil.copytree(tree / "clf", root / "clf")
    qut = root / "data/subset/processed/ntcd_timit/qutnoise_databases/test"
    rng = np.random.default_rng(9)
    for k, (spk, utt) in enumerate(list(UTTS)[:3]):
        t = np.arange(8000 + 1500 * k) / 16000
        s = 0.4 * np.sin(2 * np.pi * 180 * t) * (t % 0.3 < 0.2)
        n = 0.1 * rng.standard_normal(len(t))
        (qut / spk).mkdir(parents=True, exist_ok=True)
        for tag, sig in (("s", s), ("n", n), ("x", s + n)):
            write_wav(qut / spk / f"{utt}_{tag}.wav", sig, 16000)
    return root


def _touching_recorder(monkeypatch, module, calls):
    def record(out_path, rows, cfg=None, vmin=-40.0, vmax=20.0):
        out_path = pathlib.Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_bytes(b"")
        calls[out_path.name] = list(rows)
        return out_path

    monkeypatch.setattr(module, "save_signal_rows", record)


def _frame_rel(got, want):
    peak = np.abs(want).max(axis=-1, keepdims=True)
    return float((np.abs(got - want) / np.maximum(peak, 1e-30)).max())


RECONSTRUCT = [
    ("reconstruct_ntcd_M1", "reconstruct_ntcd_m1", "m1", []),
    ("reconstruct_ntcd_M2", "reconstruct_ntcd_m2", "m2", []),
    ("reconstruct_ntcd_M2", "reconstruct_ntcd_m2", "m2",
     ["--y-source", "classifier", "--classifier-dir", "{root}/clf"]),
    ("reconstruct_ntcd_M2_info", "reconstruct_ntcd_m2_info", "m2_info", []),
    ("reconstruct_M1", "reconstruct_m1", "m1", []),
    ("reconstruct_M2", "reconstruct_m2", "m2", []),
    ("reconstruct_M2_info", "reconstruct_m2_info", "m2_info", []),
]


@pytest.mark.parametrize("script,cli,model,extra", RECONSTRUCT,
                         ids=[f"{c}{'-classifier' if e else ''}" for _, c, _, e in RECONSTRUCT])
def test_reconstruct_cli_writes_the_jax_file_set(recon_tree, models, tmp_path, monkeypatch,
                                                jax_cache_kept, script, cli, model, extra):
    extra = [a.format(root=recon_tree) for a in extra]
    base = ["--data-root", str(recon_tree / "data"), "--h-dim", "32", "32",
            "--max-utts", "3", *extra]
    jax_calls, port_calls = {}, {}
    _touching_recorder(monkeypatch, jrec, jax_calls)
    _touching_recorder(monkeypatch, trec, port_calls)
    _jax_main(monkeypatch, script, base + ["--checkpoint", models[model][0],
                                           "--output-dir", str(tmp_path / "jax")])
    module = importlib.import_module(f"dvae_tpu_torch.cli.{cli}")
    n = module.main(base + ["--checkpoint", models[model][1], "--output-dir",
                            str(tmp_path / "port"), "--platform", "cpu"])
    per_utt = {"m1": 2, "m2": 4, "m2_info": 6}[model]
    files = {d: sorted(os.listdir(tmp_path / d)) for d in ("jax", "port")}
    # three utterances; on the NTCD walk two of them are sa1 of two speakers,
    # whose figures share a name (<noise>_<snr>_<utt>) in both packages
    assert files["port"] == files["jax"] and n == 3
    assert len(files["port"]) == per_utt * (2 if cli.startswith("reconstruct_ntcd") else 3)
    assert sorted(port_calls) == files["port"]
    for name, rows in port_calls.items():
        want = jax_calls[name]
        assert len(rows) == len(want) == 3
        for j, (row, row_j) in enumerate(zip(rows, want)):
            for k, (u, v) in enumerate(zip(row, row_j)):
                assert (u is None) == (v is None), (name, j, k)
                if u is None:
                    continue
                u, v = np.asarray(u), np.asarray(v)
                assert u.shape == v.shape, (name, j, k)
                if k == 0:  # the wav
                    np.testing.assert_array_equal(u, v)
                elif k == 2 and name.endswith("_recon_aux.png"):
                    # the auxiliary classifier on the SAMPLED latent
                    assert ((u >= 0) & (u <= 1)).all()
                elif k == 2:  # the mask: oracle, constant or the model's classifier
                    np.testing.assert_allclose(u, v, atol=1e-4)
                elif np.iscomplexobj(v):  # the mixture's / clean STFT
                    assert _frame_rel(u, v) < 1e-5, (name, j)
                else:  # a sampled reconstruction's amplitude
                    assert np.isfinite(u).all() and (u > 0).all()
