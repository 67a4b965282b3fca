"""Port parity: the audio-VAD CLI chain against the JAX scripts.

* The builder CLIs (``create_audio_train_set``, ``create_audio_set_ntcd_
  noise``, ``create_test_set``) and ``train_audio_net`` in process, with
  the builders and ``fit_sequence`` replaced by a recorder in both
  packages (as ``test_torch_port_train_cli.py`` does): the same builder
  arguments, the same utterance pairs, model widths, run directory,
  checkpoint prefix, epochs, batch size, seed and ``--std-norm`` arrays,
  the same printed lines, the same parse errors and the same exit without
  training utterances; ``--data-parallel`` alone runs at world size 1 and
  ``--multihost`` without a torchrun group fails naming torchrun.
* ``predict_vad_labels`` with both sources over a tree built by the port's
  builder: one JAX ``LSTMVad`` (hidden 8, one layer), converted to a
  ``.pt`` by ``lstm_vad_state_dict_from_jax``; the port CLI and the JAX
  script write the same files, the hard labels equal, the soft ones at
  atol 1e-5, and print the same ``vs oracle:`` line.
* The chain on the CPU with ``h5py`` blocked from import: the port's
  ``create_audio_train_set --format npz`` (``.npz`` lip videos) ->
  ``train_audio_net`` (2 epochs, hidden 8) -> ``predict_vad_labels`` ->
  ``evaluate_ntcd_m2 --y-source classifier`` and ``--y-source oracle``
  through a recording stand-in enhancer: each stage reads what the one
  before it wrote.
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
from dvae_tpu.train import checkpoint as jckpt
from dvae_tpu_torch.cli import (
    create_audio_set_ntcd_noise,
    create_audio_train_set,
    create_test_set,
    evaluate_ntcd_m2,
    predict_vad_labels,
    train_audio_net,
    train_video_net,
)
from dvae_tpu_torch.data import builders as tbuilders
from dvae_tpu_torch.data.io import read_labels
from dvae_tpu_torch.models.convert import lstm_vad_state_dict_from_jax
from _ntcd_tree import AUDIO_VIDEOS, RAW_UTTS, make_raw_tree, write_videos
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_evaluate import Recorder

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
UTTS = dict(RAW_UTTS, test={("spk04", "sa1"): 12000, ("spk04", "sx5"): 17600,
                            ("spk05", "si6"): 9600})
SUBSET = [("Babble", "-5"), ("LR", "-5")]
STATS = tbuilders.NOISY_STATS
N_TEST = 2 * len(UTTS["test"])  # mixtures of the subset grid


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A data root whose subset holds the raw tree and the processed tree
    the port's builder wrote from it (``.h5`` labels and statistics, as the
    JAX scripts read them), and one JAX LSTM as a ``.msgpack`` and a
    ``.pt``."""
    root = tmp_path_factory.mktemp("audio_corpus")
    data = root / "data"
    proc = data / "subset" / "processed"
    make_raw_tree(data / "subset" / "raw", utts=UTTS, noisy=SUBSET)
    write_videos(proc, AUDIO_VIDEOS)
    tbuilders.build_audio_train_set(data / "subset" / "raw", proc, dataset_size="subset",
                                    device="cpu")
    jm = jmodels.LSTMVad(x_dim=513, hidden=8, num_layers=1)
    params = jm.init({"params": jax.random.PRNGKey(3)}, np.zeros((1, 4, 513), np.float32))
    msgpack = jckpt.save_checkpoint(root / "jax_vad", "VAD_epoch_001_vloss_0.50", params)
    pt = root / "port_vad" / "VAD_epoch_001_vloss_0.50.pt"
    pt.parent.mkdir()
    torch.save(lstm_vad_state_dict_from_jax(jax.device_get(params)), pt)
    return data, msgpack, pt


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
        return result if result is not None else real(*a, **kw)

    monkeypatch.setattr(module, name, record)


def _jax_main(monkeypatch, script, argv):
    sys.path.insert(0, str(SCRIPTS))
    mod = importlib.import_module(script)
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv, "--platform", "cpu",
                                      "--no-jit-cache"])
    return mod.main()


BUILDERS = [
    ("create_audio_train_set", create_audio_train_set, "build_audio_train_set",
     [[], ["--splits", "train", "test", "--workers", "3", "--labels", "ibm_labels",
           "--dataset-size", "complete"]]),
    ("create_audio_set_ntcd_noise", create_audio_set_ntcd_noise, "copy_ntcd_noisy_test",
     [[], ["--split", "validation", "--dataset-size", "complete"]]),
    ("create_test_set", create_test_set, "build_qut_test_set",
     [[], ["--noise-dir", "noise", "--snrs", "-5", "0", "--seed", "4", "--split", "train"]]),
]


@pytest.mark.parametrize("script,port,builder,argv", [
    (s, p, b, a) for s, p, b, grammars in BUILDERS for a in grammars],
    ids=[f"{s}[{' '.join(a)}]" for s, _, _, grammars in BUILDERS for a in grammars])
def test_builder_cli_matches_jax_script(monkeypatch, capsys, jax_cache_kept, tmp_path,
                                        script, port, builder, argv):
    argv = ["--data-root", str(tmp_path), *argv]
    result = [-5.0, 0.0] if builder == "build_qut_test_set" else 7
    jcalls, tcalls = [], []
    _recorder(monkeypatch, jbuilders, builder, jcalls, result)
    _jax_main(monkeypatch, script, argv)
    jout = capsys.readouterr().out
    _recorder(monkeypatch, port, builder, tcalls, result)
    port.main([*argv, "--platform", "cpu"])
    tout = capsys.readouterr().out
    assert tout == jout
    (jcall,), (tcall,) = jcalls, tcalls
    own = {"fmt": "h5", "chunk": 256, "device": "cpu"} if builder == "build_audio_train_set" \
        else {}
    assert {k: v for k, v in tcall.items() if k not in own} == jcall
    assert {k: tcall[k] for k in own} == own


def test_create_audio_train_set_format_and_chunk_reach_the_builder(monkeypatch, tmp_path):
    calls = []
    _recorder(monkeypatch, create_audio_train_set, "build_audio_train_set", calls, 7)
    create_audio_train_set.main(["--data-root", str(tmp_path), "--format", "npz",
                                 "--chunk-utterances", "64"])
    assert (calls[0]["fmt"], calls[0]["chunk"], calls[0]["device"]) == ("npz", 64, None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(SystemExit) as exc:
        create_audio_train_set.main(["--data-root", str(tmp_path), "--format", "h5"])
    assert exc.value.code == 2


def _jax_lstm_widths(monkeypatch):
    """Record the widths the JAX script builds its ``LSTMVad`` with, and
    stand in for the model and for the first batch it initializes it on:
    the fit is a recorder, so no JAX array of the model is ever used, and
    tracing the LSTM's init on a loaded CPU took over 25 s."""
    widths = []

    def make(x_dim, hidden, num_layers):
        widths.append((x_dim, hidden, num_layers))
        return types.SimpleNamespace(init=lambda *a: {"params": {"w": np.zeros(1, np.float32)}})

    monkeypatch.setattr(jmodels, "LSTMVad", make)
    monkeypatch.setattr(jsequence, "batch_utterances", lambda *a, **kw: (None, None, None))
    return widths


def _train_records(monkeypatch, module):
    """Replace ``fit_sequence`` by a recorder and wrap ``make_lstm_vad_step``
    to record the model and the ``norm`` it is given."""
    fits, steps = [], []
    _recorder(monkeypatch, module, "fit_sequence", fits, result=[])
    real = module.make_lstm_vad_step

    def step(model, tx, eps=1e-8, norm=None, **mesh):  # the port's takes mesh=
        steps.append((model, norm))
        return real(model, tx, eps, norm, **mesh)

    monkeypatch.setattr(module, "make_lstm_vad_step", step)
    return fits, steps


TRAIN_GRAMMARS = [
    [],
    ["--hidden", "8", "--num-layers", "1", "--std-norm"],
    ["--hidden", "8", "--num-layers", "1", "--run-name", "vad_resume", "--start-epoch", "3",
     "--end-epoch", "7", "--seed", "5", "--seq-batch-size", "4", "--learning-rate", "3e-4"],
    ["--hidden", "8", "--num-layers", "1", "--train-split", "test", "--valid-split", "train",
     "--std-norm", "--stats-h5", "STATS"],
]


@pytest.mark.parametrize("extra", TRAIN_GRAMMARS, ids=[" ".join(e) for e in TRAIN_GRAMMARS])
def test_train_audio_net_matches_jax_script(corpus, monkeypatch, capsys, jax_cache_kept, extra):
    data = corpus[0]
    stats = data / "subset" / "processed" / f"{STATS}.h5"
    argv = ["--data-root", str(data), "--models-root", "models",
            *[str(stats) if a == "STATS" else a for a in extra]]
    jfits, jsteps = _train_records(monkeypatch, jsequence)
    widths = _jax_lstm_widths(monkeypatch)
    _jax_main(monkeypatch, "train_audio_net", argv)
    jout = capsys.readouterr().out
    tfits, tsteps = _train_records(monkeypatch, train_audio_net)
    train_audio_net.main([*argv, "--platform", "cpu"])
    tout = capsys.readouterr().out
    assert tout == jout and "train /" in tout
    (jfit,), (tfit,) = jfits, tfits
    for k in ("model_dir", "prefix", "seed", "start_epoch", "end_epoch", "batch_size"):
        assert tfit[k] == jfit[k], k
    assert tfit["prefix"] == "VAD" and tfit["mesh"] is None
    assert tfit["model_dir"].startswith(os.path.join("models", "ntcd_audio_vad_lstm_")) or \
        "--run-name" in extra
    for split in ("train_ds", "valid_ds"):
        assert tfit[split].pairs == jfit[split].pairs and len(tfit[split]) > 0
    (_, jnorm), (tmodel, tnorm) = jsteps[0], tsteps[0]
    assert [(tmodel.lstm.input_size, tmodel.lstm.hidden_size, tmodel.lstm.num_layers)] == \
        widths
    assert tfit["opt"].param_groups[0]["lr"] == float(extra[extra.index("--learning-rate") + 1]
                                                      if "--learning-rate" in extra else 1e-4)
    assert (tnorm is None) == (jnorm is None)
    if jnorm is not None:
        for a, b in zip(tnorm, jnorm):
            np.testing.assert_array_equal(a, b)
    # one batch of the port's batcher: a log-power batch over the pairs
    x, y, mask = tfit["batcher"](tfit["train_ds"], [0])
    assert x.shape[-1] == 513 and y.shape == mask.shape == x.shape[:2]


def test_train_audio_net_reads_npz_statistics(corpus, monkeypatch, tmp_path):
    """``--stats-h5`` takes the ``.npz`` of the builder's statistics: the
    same ``norm`` as its ``.h5``."""
    h5 = corpus[0] / "subset" / "processed" / f"{STATS}.h5"
    npz = tbuilders.frames_h5_to_npz(h5, tmp_path / "stats.npz")
    norms = []
    for path in (h5, npz):
        _, steps = _train_records(monkeypatch, train_audio_net)
        train_audio_net.main(["--data-root", str(corpus[0]), "--hidden", "8", "--std-norm",
                              "--stats-h5", str(path), "--platform", "cpu",
                              "--models-root", str(tmp_path)])
        norms.append(steps[0][1])
    for a, b in zip(*norms):
        assert a.shape == (513, 1)
        np.testing.assert_array_equal(a, b)


PARSE_ERRORS = [("train_audio_net", ["--labels", "ibm_labels"]),
                ("predict_vad_labels", ["--labels", "ibm_labels", "--checkpoint", "x"]),
                ("predict_vad_labels", []),
                ("predict_vad_labels", ["--model-dir", "m", "--source", "clean", "--shard", "2/2"])]


@pytest.mark.parametrize("script,argv", PARSE_ERRORS,
                         ids=[f"{s}[{' '.join(a)}]" for s, a in PARSE_ERRORS])
def test_vad_cli_errors_match_jax(corpus, monkeypatch, capsys, jax_cache_kept, script, argv):
    argv = ["--data-root", str(corpus[0]), *argv]
    with pytest.raises(SystemExit) as jexit:
        _jax_main(monkeypatch, script, argv)
    jerr = capsys.readouterr().err
    port = {"train_audio_net": train_audio_net, "predict_vad_labels": predict_vad_labels}[script]
    with pytest.raises(SystemExit) as texit:
        port.main([*argv, "--platform", "cpu"])
    terr = capsys.readouterr().err
    assert texit.value.code == jexit.value.code
    assert terr.split("error: ")[-1] == jerr.split("error: ")[-1]


def test_train_audio_net_exits_without_utterances(monkeypatch, capsys, jax_cache_kept,
                                                  tmp_path):
    argv = ["--data-root", str(tmp_path)]
    with pytest.raises(SystemExit) as jexit:
        _jax_main(monkeypatch, "train_audio_net", argv)
    with pytest.raises(SystemExit) as texit:
        train_audio_net.main([*argv, "--platform", "cpu"])
    assert str(texit.value) == str(jexit.value) == \
        "no training utterances found; run the create_* builders"


@pytest.mark.parametrize("script,argv,said", [
    ("train_audio_net", ["--data-parallel"], "no training utterances found"),
    ("train_audio_net", ["--multihost"], "--multihost was requested"),
    ("train_video_net", ["--data-parallel"], "no training utterances found"),
    ("train_video_net", ["--multihost"], "--multihost was requested"),
])
def test_vad_clis_refuse_what_is_not_ported(tmp_path, monkeypatch, script, argv, said):
    """``--data-parallel`` launched alone is world size 1 over the
    process's device: the run goes on to the (empty) corpus. ``--multihost``
    without a torchrun group of more than one process fails loudly, naming
    torchrun, before any data is read."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    port = {"train_audio_net": train_audio_net, "train_video_net": train_video_net}[script]
    with pytest.raises((SystemExit, RuntimeError)) as exc:
        port.main(["--data-root", str(tmp_path), "--platform", "cpu", *argv])
    assert said in str(exc.value)
    assert argv == ["--data-parallel"] or "torchrun" in str(exc.value)


def _outputs(root):
    return {str(p.relative_to(root)): np.load(p) for p in sorted(pathlib.Path(root).rglob("*.npy"))}


@pytest.mark.parametrize("extra", [["--snr", "all"], ["--source", "clean", "--std-norm"],
                                   ["--snr", "-5", "--shard", "1/2", "--seq-batch-size", "2"]],
                         ids=["noisy", "clean-std-norm", "shard"])
def test_predict_vad_labels_matches_jax_script(corpus, monkeypatch, capsys, jax_cache_kept,
                                               tmp_path, extra):
    data, msgpack, pt = corpus
    base = ["--data-root", str(data), "--hidden", "8", "--num-layers", "1", *extra]
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

    assert said(tout, "vs oracle:") == said(jout, "vs oracle:") != []
    assert said(tout, "predicted") == said(jout, "predicted")
    assert said(tout, "done:")[0].split(" -> ")[0] == said(jout, "done:")[0].split(" -> ")[0]
    if "clean" in extra:  # one file pair per utterance, on the clean layout
        assert n == len(UTTS["test"]) and all("/Clean/test/" in k for k in got)
    # resume-by-skip, then --overwrite
    argv = base + ["--checkpoint", str(pt), "--output-dir", str(tmp_path / "port"),
                   "--platform", "cpu"]
    assert predict_vad_labels.main(argv) == 0
    assert predict_vad_labels.main(argv + ["--overwrite"]) == n


def test_predict_vad_labels_skips_missing_inputs(corpus, tmp_path, capsys):
    """The catalog names the whole grid: ``--dataset-size complete`` finds
    the subset's mixtures and counts the rest as missing."""
    data, _, pt = corpus
    complete = tmp_path / "data" / "complete"
    complete.mkdir(parents=True)
    (complete / "processed").symlink_to(data / "subset" / "processed")
    n = predict_vad_labels.main(["--data-root", str(tmp_path / "data"), "--dataset-size",
                                 "complete", "--snr", "all", "--hidden", "8", "--num-layers",
                                 "1", "--checkpoint", str(pt), "--output-dir",
                                 str(tmp_path / "out"), "--platform", "cpu"])
    out = capsys.readouterr().out
    assert n == N_TEST
    assert f"skipping {30 * len(UTTS['test']) - N_TEST} utterances with missing input" in out


def test_the_chain_runs_from_npz_files_without_h5py(tmp_path, monkeypatch, capsys):
    """``create_audio_train_set --format npz`` -> ``train_audio_net`` ->
    ``predict_vad_labels`` -> ``evaluate_ntcd_m2`` (classifier and oracle
    labels) on the CPU, with ``h5py`` blocked from import."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    data = tmp_path / "data"
    proc = data / "subset" / "processed"
    make_raw_tree(data / "subset" / "raw", utts=UTTS, noisy=SUBSET)
    videos = dict(AUDIO_VIDEOS)
    videos["test", "spk04", "sx5"] = (4, 4, 30)  # a test video: the sweep trims
    write_videos(proc, videos, "npz")
    stats = create_audio_train_set.main(["--data-root", str(data), "--format", "npz",
                                         "--chunk-utterances", "2", "--platform", "cpu"])
    assert stats == proc / f"{STATS}.npz"
    labels = sorted(proc.rglob("*_vad_labels_upsampled.npz"))
    assert len(labels) == sum(len(u) for u in UTTS.values())
    assert not list(proc.rglob("*_vad_labels_upsampled.h5"))

    models = tmp_path / "models"
    hist = train_audio_net.main(["--data-root", str(data), "--models-root", str(models),
                                 "--end-epoch", "3", "--hidden", "8", "--num-layers", "1",
                                 "--seq-batch-size", "4", "--std-norm", "--stats-h5",
                                 str(stats), "--platform", "cpu"])
    run = models / "ntcd_audio_vad_lstm_8x1_norm"
    assert len(hist) == 2 and all(np.isfinite(h["train"]["bce"]) for h in hist)
    assert len(list(run.glob("VAD_epoch_*_vloss_*.opt.pt"))) == 2

    preds = tmp_path / "preds"
    n = predict_vad_labels.main(["--data-root", str(data), "--model-dir", str(run),
                                 "--hidden", "8", "--num-layers", "1", "--std-norm",
                                 "--stats-h5", str(stats), "--snr", "all", "--output-dir",
                                 str(preds), "--platform", "cpu"])
    assert n == N_TEST
    assert "vs oracle: accuracy=" in capsys.readouterr().out

    seen = {}
    for source in ("classifier", "oracle"):
        rec = Recorder("none")
        monkeypatch.setattr(evaluate_ntcd_m2, "build_enhancer",
                            lambda args, *a, rec=rec: (rec, str(tmp_path / "enh"), None))
        argv = ["--data-root", str(data), "--checkpoint", "unused.pt", "--snr", "all",
                "--y-source", source, "--platform", "cpu", "--batch-size", "4"]
        if source == "classifier":
            argv += ["--classifier-dir", str(preds)]
        assert evaluate_ntcd_m2.main(argv) == N_TEST
        seen[source] = rec.batches
    for (_, ys_c, mf_c, _), (_, ys_o, mf_o, _) in zip(seen["classifier"], seen["oracle"]):
        assert mf_c == mf_o
        for yc, yo in zip(ys_c, ys_o):
            assert yc.shape == yo.shape and set(np.unique(yc)) <= {0.0, 1.0}
    mf = [m for _, _, mfs, _ in seen["oracle"] for m in mfs]
    assert sorted(mf)[:2] == [30, 30] and mf.count(10**9) == N_TEST - 2
    # the classifier labels are the predicted files, the oracle ones the .npz
    hard = sorted(preds.rglob("*_y_hat_hard.npy"))
    assert len(hard) == N_TEST
    got = sorted(float(y.sum()) for _, ys, _, _ in seen["classifier"] for y in ys)
    assert got == sorted(float(np.load(p).sum()) for p in hard)
    oracle = sorted(float(y.sum()) for _, ys, _, _ in seen["oracle"] for y in ys)
    test_labels = [p for p in labels if "/test/" in str(p)]
    assert oracle == sorted(2 * [float(read_labels(p).sum()) for p in test_labels])
