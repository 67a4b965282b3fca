"""Port parity: the lip-video and audio-visual VAD chain against the JAX
scripts, on the CPU.

* ``create_video_train_files`` in process against the JAX script (the
  builder replaced by a recorder in both packages: the same arguments and
  output), then for real against the JAX ``build_video_files`` on a raw
  tree of matlab v7.3-style ``.mat`` lip files (``tests/_ntcd_tree.py``):
  every video within 1e-3 on the 0-255 scale, labels exact, pixel
  statistics at rtol 1e-5, as ``.h5`` and as ``.npz``.
* ``proc_video_audio_pair_dict(upsampled=True)`` over ``.h5``, ``.npz`` and
  both: one entry per utterance, the ``.h5`` kept, the JAX catalog's order.
* ``train_video_net`` for both modalities, with the fitter replaced by a
  recorder in both packages (and the JAX model by a stand-in, whose init on
  a CPU batch is not what is compared): the same utterances in the same
  order, norm, widths, run directory and checkpoint prefix, printed lines.
* ``predict_vad_labels --modality video|av`` with one JAX model (hidden 8,
  one layer, emb_dim 4) converted by ``video_vad_state_dict_from_jax``:
  the same files, frame counts and hard labels, soft labels at atol 1e-5,
  the same ``vs oracle:`` line.
* The chain with ``h5py`` blocked after the ``.mat`` walk: ``.npz`` videos
  -> ``train_video_net`` (both modalities) -> ``predict_vad_labels`` ->
  ``evaluate_ntcd_m2 --y-source classifier`` through a recording stand-in
  enhancer.
"""

import importlib
import inspect
import os
import pathlib
import sys
import types

import jax
import numpy as np
import pytest
import torch

import dvae_tpu.data.builders as jbuilders
import dvae_tpu.models as jmodels
import dvae_tpu.train.sequence as jsequence
from dvae_tpu.data.catalog import ntcd_timit as jcatalog
from dvae_tpu.train import checkpoint as jckpt
from dvae_tpu_torch.cli import (
    create_video_train_files,
    evaluate_ntcd_m2,
    predict_vad_labels,
    train_video_net,
)
from dvae_tpu_torch.data import builders as tbuilders
from dvae_tpu_torch.data.catalog import ntcd_timit as tcatalog
from dvae_tpu_torch.data.io import load_arrays, read_labels
from dvae_tpu_torch.models.convert import video_vad_state_dict_from_jax
from _ntcd_tree import RAW_UTTS, make_raw_tree, write_lip_mats
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_evaluate import Recorder

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
UTTS = dict(RAW_UTTS, test={("spk04", "sa1"): 12000, ("spk04", "sx5"): 17600,
                            ("spk05", "si6"): 9600})
SUBSET = [("Babble", "-5"), ("LR", "-5")]
N_TEST = len(UTTS["test"])


def _raw(data):
    raw = data / "subset" / "raw"
    make_raw_tree(raw, utts=UTTS, noisy=SUBSET)
    write_lip_mats(raw, UTTS)
    return raw


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A data root whose subset holds the raw tree with lip ``.mat`` files
    and the processed tree the port's builders wrote from it (``.h5``, as
    the JAX scripts read it), and one JAX ``VideoVad`` and ``AVVad``, each
    as a ``.msgpack`` and a ``.pt``."""
    root = tmp_path_factory.mktemp("video_corpus")
    data = root / "data"
    raw, proc = _raw(data), data / "subset" / "processed"
    tbuilders.build_video_files(raw, proc, device="cpu")
    tbuilders.build_audio_train_set(raw, proc, dataset_size="subset", device="cpu")
    models = {}
    dummy_v = np.zeros((1, 4, 67, 67), np.float32)
    for kind, jm, x in [("video", jmodels.VideoVad(hidden=8, num_layers=1, emb_dim=4), dummy_v),
                        ("av", jmodels.AVVad(x_dim=513, hidden=8, num_layers=1, emb_dim=4),
                         (np.zeros((1, 4, 513), np.float32), dummy_v))]:
        params = jm.init({"params": jax.random.PRNGKey(5)}, x)
        prefix = {"video": "Video_Net", "av": "AV_Net"}[kind]
        msgpack = jckpt.save_checkpoint(root / f"jax_{kind}", f"{prefix}_epoch_001_vloss_0.50",
                                        params)
        pt = root / f"port_{kind}" / f"{prefix}_epoch_001_vloss_0.50.pt"
        pt.parent.mkdir()
        torch.save(video_vad_state_dict_from_jax(jax.device_get(params)), pt)
        models[kind] = (msgpack, pt)
    return data, models


@pytest.fixture
def jax_cache_kept():
    """``--no-jit-cache`` turns the JAX compile cache off for the process:
    put back what the suite had."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def _call(fn, args, kwargs):
    ba = inspect.signature(fn).bind(*args, **kwargs)
    ba.apply_defaults()
    return dict(ba.arguments)


def _recorder(monkeypatch, module, name, calls, result=None):
    real = getattr(module, name)

    def record(*a, **kw):
        calls.append(_call(real, a, kw))
        return result

    monkeypatch.setattr(module, name, record)


def _jax_main(monkeypatch, script, argv):
    sys.path.insert(0, str(SCRIPTS))
    mod = importlib.import_module(script)
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv, "--platform", "cpu",
                                      "--no-jit-cache"])
    return mod.main()


@pytest.mark.parametrize("argv", [[], ["--splits", "train", "test", "--workers", "2",
                                       "--labels", "ibm_labels", "--dataset-size",
                                       "complete"]], ids=["defaults", "flags"])
def test_create_video_train_files_cli_matches_jax_script(monkeypatch, capsys, jax_cache_kept,
                                                         tmp_path, argv):
    argv = ["--data-root", str(tmp_path), *argv]
    jcalls, tcalls = [], []
    _recorder(monkeypatch, jbuilders, "build_video_files", jcalls)
    _jax_main(monkeypatch, "create_video_train_files", argv)
    jout = capsys.readouterr().out
    _recorder(monkeypatch, create_video_train_files, "build_video_files", tcalls)
    create_video_train_files.main([*argv, "--platform", "cpu"])
    assert capsys.readouterr().out == jout == "done\n"
    (jcall,), (tcall,) = jcalls, tcalls
    own = {"fmt": "h5", "device": "cpu"}
    assert {k: v for k, v in tcall.items() if k not in own} == jcall
    assert {k: tcall[k] for k in own} == own


def _kind(name: str) -> str:
    return ("stats" if "statistics" in name else "labels" if "_labels_upsampled" in name
            else "video")


def _arrays(proc):
    """{relative path without suffix: arrays} of every processed file."""
    names = {"stats": ("X_train_mean", "X_train_std"), "labels": ("Y",), "video": ("X",)}
    return {str(p.relative_to(proc).with_suffix("")): load_arrays(p, *names[_kind(p.name)])
            for p in sorted(pathlib.Path(proc).rglob("*")) if p.suffix in (".h5", ".npz")}


@pytest.mark.parametrize("fmt,labels", [("h5", "vad_labels"), ("npz", "vad_labels"),
                                        ("npz", "ibm_labels")])
def test_create_video_train_files_matches_jax_builder(tmp_path, fmt, labels):
    data = tmp_path / "data"
    raw = _raw(data)
    jproc = tmp_path / "jax"
    jbuilders.build_video_files(raw, jproc, labels=labels)
    stats = create_video_train_files.main(["--data-root", str(data), "--format", fmt,
                                           "--labels", labels, "--platform", "cpu"])
    proc = data / "subset" / "processed"
    assert stats == proc / f"{tbuilders.VIDEO_STATS}.{fmt}"
    want, got = _arrays(jproc), _arrays(proc)
    assert got.keys() == want.keys()
    assert len(got) == 2 * sum(len(u) for u in UTTS.values()) + 1
    assert not list(proc.rglob("*.h5" if fmt == "npz" else "*.npz"))
    for k, w in want.items():
        for a, b in zip(got[k], w):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
            if _kind(k) == "stats":
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
            elif _kind(k) == "video":
                assert a.shape[:2] == (67, 67)
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
    # each video has its label file's frames
    for k, arrays in got.items():
        if _kind(k) == "video":
            x = arrays[0]
            lab = k.replace("matlab_raw", "Clean")[:-len("_upsampled")] + f"_{labels}_upsampled"
            assert x.shape[-1] == got[lab][0].shape[-1]


def test_mat_walk_without_h5py_names_the_host_route(tmp_path, monkeypatch):
    data = tmp_path / "data"
    _raw(data)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="matlab v7.3 .* need h5py.*--format npz"):
        create_video_train_files.main(["--data-root", str(data), "--format", "npz",
                                       "--platform", "cpu"])
    with pytest.raises(SystemExit) as exc:
        create_video_train_files.main(["--data-root", str(data), "--platform", "cpu"])
    assert exc.value.code == 2


@pytest.mark.parametrize("layout", ["h5", "npz", "both"])
def test_video_pair_walk_takes_either_suffix(tmp_path, layout):
    proc = tmp_path
    utts = [("spk01", "sa1"), ("spk01", "sx2"), ("spk02", "si3")]
    for spk, utt in utts:
        for sub, stem in (("matlab_raw", f"{utt}_upsampled"), ("Clean", f"{utt}_vad_labels")):
            d = proc / "ntcd_timit" / sub / "test" / spk
            d.mkdir(parents=True, exist_ok=True)
            for ext in {"h5": ["h5"], "npz": ["npz"], "both": ["h5", "npz"]}[layout]:
                (d / f"{stem}.{ext}").write_bytes(b"")
    video, audio = tcatalog.proc_video_audio_pair_dict(str(proc) + "/", "test",
                                                       upsampled=True)
    ext = "npz" if layout == "npz" else "h5"
    assert len(video) == len(audio) == len(utts)
    assert all(v.endswith(f"_upsampled.{ext}") for v in video)
    assert all(a.endswith(f"_vad_labels.{ext}") for a in audio)
    jvideo, jaudio = jcatalog.proc_video_audio_pair_dict(str(proc) + "/", "test",
                                                         upsampled=True)
    if layout != "npz":
        assert (video, audio) == (jvideo, jaudio)
    else:
        assert [v[:-4] for v in video] == [os.path.splitext(v)[0] for v in sorted(
            os.path.relpath(p, proc) for p in proc.rglob("*_upsampled.npz"))]
    # the plain walk stays the JAX one (.h5 files alone)
    assert tcatalog.proc_video_audio_pair_dict(str(proc) + "/", "test") == \
        jcatalog.proc_video_audio_pair_dict(str(proc) + "/", "test")


def _jax_models_stand_in(monkeypatch):
    """Record the widths the JAX script builds its model with, and stand in
    for it and the first batch it initializes it on: the fit is a
    recorder, so no JAX array of the model is used."""
    widths = []

    def make(cls):
        def build(**kw):
            widths.append((cls, kw))
            return types.SimpleNamespace(
                init=lambda *a: {"params": {"w": np.zeros(1, np.float32)}})
        return build

    monkeypatch.setattr(jmodels, "VideoVad", make("VideoVad"))
    monkeypatch.setattr(jmodels, "AVVad", make("AVVad"))
    for name in ("batch_video_utterances", "batch_av_utterances"):
        monkeypatch.setattr(jsequence, name, lambda *a, **kw: (None, None, None))
    return widths


def _train_records(monkeypatch, module):
    fits, steps = [], []
    _recorder(monkeypatch, module, "fit_sequence", fits, result=[])
    real = module.make_lstm_vad_step

    def step(model, tx, eps=1e-8, norm=None, **mesh):  # the port's takes mesh=
        steps.append((model, norm))
        return real(model, tx, eps, norm, **mesh)

    monkeypatch.setattr(module, "make_lstm_vad_step", step)
    return fits, steps


TRAIN_GRAMMARS = [
    ["--modality", "video"],
    ["--modality", "video", "--hidden", "8", "--num-layers", "1", "--emb-dim", "4",
     "--std-norm", "--run-name", "vid", "--start-epoch", "3", "--end-epoch", "7",
     "--seed", "5", "--seq-batch-size", "4", "--learning-rate", "3e-4"],
    ["--modality", "av", "--hidden", "8", "--num-layers", "1", "--emb-dim", "4"],
    ["--modality", "av", "--hidden", "8", "--num-layers", "1", "--std-norm",
     "--train-split", "test", "--valid-split", "train", "--video-stats-h5", "VSTATS",
     "--stats-h5", "ASTATS"],
]


def _stats_paths(data, argv):
    proc = data / "subset" / "processed"
    sub = {"VSTATS": str(proc / f"{tbuilders.VIDEO_STATS}.h5"),
           "ASTATS": str(proc / f"{tbuilders.NOISY_STATS}.h5")}
    return [sub.get(a, a) for a in argv]


@pytest.mark.parametrize("extra", TRAIN_GRAMMARS, ids=[" ".join(e) for e in TRAIN_GRAMMARS])
def test_train_video_net_matches_jax_script(corpus, monkeypatch, capsys, jax_cache_kept, extra):
    data = corpus[0]
    argv = ["--data-root", str(data), "--models-root", "models", *_stats_paths(data, extra)]
    jfits, jsteps = _train_records(monkeypatch, jsequence)
    widths = _jax_models_stand_in(monkeypatch)
    _jax_main(monkeypatch, "train_video_net", argv)
    jout = capsys.readouterr().out
    tfits, tsteps = _train_records(monkeypatch, train_video_net)
    train_video_net.main([*argv, "--platform", "cpu"])
    tout = capsys.readouterr().out
    assert tout == jout and "train /" in tout
    (jfit,), (tfit,) = jfits, tfits
    for k in ("model_dir", "prefix", "seed", "start_epoch", "end_epoch", "batch_size"):
        assert tfit[k] == jfit[k], k
    av = "av" in extra
    assert tfit["prefix"] == ("AV_Net" if av else "Video_Net")
    for split in ("train_ds", "valid_ds"):
        jds, tds = jfit[split], tfit[split]
        if av:
            assert [tuple(map(str, t)) for t in tds.triples] == \
                [tuple(map(str, t)) for t in jds.triples]
        else:
            assert [tuple(map(str, p)) for p in tds.pairs] == \
                [tuple(map(str, p)) for p in jds.pairs]
    assert len(tfit["train_ds"]) > 0
    (_, jnorm), (tmodel, tnorm) = jsteps[0], tsteps[0]
    (cls, kw), = widths
    assert type(tmodel).__name__ == cls
    assert (tmodel.lstm.hidden_size, tmodel.lstm.num_layers, tmodel.lip.proj.out_features) == \
        (kw["hidden"], kw["num_layers"], kw["emb_dim"])
    assert tmodel.lstm.input_size == kw["emb_dim"] + (kw.get("x_dim", 0))
    assert tfit["opt"].param_groups[0]["lr"] == float(
        extra[extra.index("--learning-rate") + 1] if "--learning-rate" in extra else 1e-4)
    assert (tnorm is None) == (jnorm is None)
    if jnorm is not None:
        flat = lambda n: [a for part in (n if av else (n,)) for a in part]  # noqa: E731
        for a, b in zip(flat(tnorm), flat(jnorm), strict=True):
            np.testing.assert_array_equal(a, b)
    # one batch of the port's batcher
    x, y, mask = tfit["batcher"](tfit["train_ds"], [0])
    video = x[1] if av else x
    assert video.shape[2:] == (67, 67) and y.shape == mask.shape == video.shape[:2]
    if av:
        assert x[0].shape == (*y.shape, 513)


PARSE_ERRORS = [("train_video_net", ["--labels", "ibm_labels"]),
                ("train_video_net", ["--modality", "audio"]),
                ("predict_vad_labels", ["--modality", "video", "--source", "clean",
                                        "--checkpoint", "x"]),
                ("predict_vad_labels", ["--modality", "av", "--source", "noisy",
                                        "--checkpoint", "x"])]


@pytest.mark.parametrize("script,argv", PARSE_ERRORS,
                         ids=[f"{s}[{' '.join(a)}]" for s, a in PARSE_ERRORS])
def test_video_cli_errors_match_jax(corpus, monkeypatch, capsys, jax_cache_kept, script, argv):
    argv = ["--data-root", str(corpus[0]), *argv]
    with pytest.raises(SystemExit) as jexit:
        _jax_main(monkeypatch, script, argv)
    jerr = capsys.readouterr().err
    port = {"train_video_net": train_video_net, "predict_vad_labels": predict_vad_labels}[script]
    with pytest.raises(SystemExit) as texit:
        port.main([*argv, "--platform", "cpu"])
    terr = capsys.readouterr().err
    assert texit.value.code == jexit.value.code == 2
    assert terr.split("error: ")[-1] == jerr.split("error: ")[-1]


def test_train_video_net_exits_without_utterances(monkeypatch, jax_cache_kept, tmp_path):
    for modality in ("video", "av"):
        argv = ["--data-root", str(tmp_path), "--modality", modality]
        with pytest.raises(SystemExit) as jexit:
            _jax_main(monkeypatch, "train_video_net", argv)
        with pytest.raises(SystemExit) as texit:
            train_video_net.main([*argv, "--platform", "cpu"])
        assert str(texit.value) == str(jexit.value) == \
            "no training utterances found; run the create_* builders"


def _outputs(root):
    return {str(p.relative_to(root)): np.load(p) for p in sorted(pathlib.Path(root).rglob("*.npy"))}


@pytest.mark.parametrize("modality,extra", [("video", []), ("video", ["--std-norm"]),
                                            ("av", ["--snr", "all"]),
                                            ("av", ["--snr", "-5", "--std-norm",
                                                    "--seq-batch-size", "2"])],
                         ids=["video", "video-std-norm", "av", "av-std-norm"])
def test_predict_vad_labels_matches_jax_script(corpus, monkeypatch, capsys, jax_cache_kept,
                                               tmp_path, modality, extra):
    data, models = corpus
    msgpack, pt = models[modality]
    base = ["--data-root", str(data), "--modality", modality, "--hidden", "8",
            "--num-layers", "1", "--emb-dim", "4", *extra]
    _jax_main(monkeypatch, "predict_vad_labels",
              base + ["--checkpoint", str(msgpack), "--output-dir", str(tmp_path / "jax")])
    jout = capsys.readouterr().out
    n = predict_vad_labels.main(base + ["--checkpoint", str(pt), "--output-dir",
                                        str(tmp_path / "port"), "--platform", "cpu"])
    tout = capsys.readouterr().out
    want, got = _outputs(tmp_path / "jax"), _outputs(tmp_path / "port")
    assert got.keys() == want.keys() and len(got) == 2 * n > 0
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        if k.endswith("_y_hat_hard.npy"):
            np.testing.assert_array_equal(got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0)

    def said(out, tag):
        return [line for line in out.splitlines() if line.startswith(tag)]

    for tag in ("vs oracle:", "predicted", "audio std-norm", "video std-norm"):
        assert said(tout, tag) == said(jout, tag), tag
    assert said(tout, "vs oracle:") != []
    if modality == "video":  # one file pair per utterance, on the clean layout
        assert n == N_TEST and all("/Clean/test/" in k for k in got)
    else:
        assert n == len(SUBSET) * N_TEST and all("/Noisy/" in k for k in got)
    argv = base + ["--checkpoint", str(pt), "--output-dir", str(tmp_path / "port"),
                   "--platform", "cpu"]
    assert predict_vad_labels.main(argv) == 0
    assert predict_vad_labels.main(argv + ["--overwrite"]) == n


def test_the_video_chain_runs_from_npz_files_without_h5py(tmp_path, monkeypatch, capsys):
    """``create_video_train_files --format npz`` (which reads the ``.mat``
    files with ``h5py``), then with ``h5py`` blocked: ``create_audio_train_
    set``'s ``.npz`` files, ``train_video_net`` for both modalities,
    ``predict_vad_labels --modality video`` and ``evaluate_ntcd_m2
    --y-source classifier`` on its labels."""
    data = tmp_path / "data"
    raw, proc = _raw(data), data / "subset" / "processed"
    vstats = create_video_train_files.main(["--data-root", str(data), "--format", "npz",
                                            "--platform", "cpu"])
    monkeypatch.setitem(sys.modules, "h5py", None)
    astats = tbuilders.build_audio_train_set(raw, proc, dataset_size="subset", fmt="npz",
                                             device="cpu")
    assert not list(proc.rglob("*.h5"))
    models = tmp_path / "models"
    runs = {}
    for modality in ("video", "av"):
        hist = train_video_net.main(["--data-root", str(data), "--models-root", str(models),
                                     "--modality", modality, "--end-epoch", "3", "--hidden",
                                     "8", "--num-layers", "1", "--emb-dim", "4",
                                     "--seq-batch-size", "2", "--std-norm",
                                     "--video-stats-h5", str(vstats), "--stats-h5",
                                     str(astats), "--platform", "cpu"])
        runs[modality] = models / f"ntcd_{modality}_vad_8x1_norm"
        prefix = "AV_Net" if modality == "av" else "Video_Net"
        assert len(hist) == 2 and all(np.isfinite(h["train"]["bce"]) for h in hist)
        assert len(list(runs[modality].glob(f"{prefix}_epoch_*_vloss_*.opt.pt"))) == 2

    preds = {}
    for modality in ("video", "av"):
        preds[modality] = tmp_path / f"preds_{modality}"
        n = predict_vad_labels.main(["--data-root", str(data), "--model-dir",
                                     str(runs[modality]), "--modality", modality, "--hidden",
                                     "8", "--num-layers", "1", "--emb-dim", "4", "--std-norm",
                                     "--video-stats-h5", str(vstats), "--stats-h5",
                                     str(astats), "--snr", "all", "--output-dir",
                                     str(preds[modality]), "--platform", "cpu"])
        assert n == (N_TEST if modality == "video" else len(SUBSET) * N_TEST)
        assert "vs oracle: accuracy=" in capsys.readouterr().out
    # each video prediction has its label file's frames
    for hard in preds["video"].rglob("*_y_hat_hard.npy"):
        rel = hard.relative_to(preds["video"])
        lab = proc / rel.parent / rel.name.replace("_y_hat_hard.npy",
                                                   "_vad_labels_upsampled.npz")
        assert np.load(hard).shape == (read_labels(lab).shape[1],)

    rec = Recorder("none")
    monkeypatch.setattr(evaluate_ntcd_m2, "build_enhancer",
                        lambda args, *a: (rec, str(tmp_path / "enh"), None))
    assert evaluate_ntcd_m2.main(["--data-root", str(data), "--checkpoint", "unused.pt",
                                  "--snr", "all", "--y-source", "classifier",
                                  "--classifier-dir", str(preds["video"]), "--platform", "cpu",
                                  "--batch-size", "4"]) == len(SUBSET) * N_TEST
    got = sorted(float(y.sum()) for _, ys, _, _ in rec.batches for y in ys)
    want = sorted(2 * [float(np.load(p).sum()) for p in preds["video"].rglob("*_y_hat_hard.npy")])
    assert got == want
