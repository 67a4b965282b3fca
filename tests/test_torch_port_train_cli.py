"""Port parity: the frame-set builder, its formats, the streamed dataset
and the trainer CLIs against the JAX package's.

* ``build_frame_dataset`` on a synthetic raw tree (``_ntcd_tree.
  make_raw_tree``: five short utterances in two splits, two of them with a
  lip video that trims, with and without the legacy trim): the rows at
  rtol 1e-4 above 1e-6 of the peak, as ``test_torch_port_stft_power.py``
  holds the spectrogram; the train mean and std at rtol 1e-4; VAD labels
  exactly, IBM labels on all but at most 1e-4 of the bins.
* The ``.h5`` and ``.npz`` routes and ``frames_h5_to_npz`` give the same
  datasets and the same 2-epoch ``fit_vae`` run; a streamed ``.h5``
  (``in_memory=False``) gives JAX's streamed batches.
* The trainer CLIs in process, with the fitter replaced by a recorder on
  both sides: the model, run directory, checkpoint prefix, every
  ``LoopConfig`` field and every fit keyword argument equal the JAX
  script's, for every family, variant and name grammar, and so do the
  printed lines and the parse errors.
"""

import dataclasses
import importlib
import inspect
import pathlib
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

import dvae_tpu.data.builders as jbuilders
import dvae_tpu.data.datasets as jdatasets
import dvae_tpu.models as jmodels
import dvae_tpu.train.loop as jloop
from dvae_tpu.train import checkpoint as jckpt
from dvae_tpu_torch.data import builders as tbuilders
from dvae_tpu_torch.data.datasets import FrameDataset
from dvae_tpu_torch.models import VAE
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.train.loop import LoopConfig, fit_vae
from _ntcd_tree import make_raw_tree
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
H = (32, 32)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw_tree")
    make_raw_tree(root / "raw", proc=root / "videos")
    return root


def _read_h5(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}


@pytest.mark.parametrize("legacy", [False, True], ids=["trim", "legacy-trim"])
@pytest.mark.parametrize("labels", ["vad_labels", "ibm_labels"])
def test_build_frame_dataset_matches_jax(raw, tmp_path, labels, legacy):
    kw = dict(labels=labels, proc_video_dir=raw / "videos", legacy_video_trim=legacy)
    want = _read_h5(jbuilders.build_frame_dataset(raw / "raw", tmp_path / "jax", **kw))
    path = tbuilders.build_frame_dataset(raw / "raw", tmp_path / "port", fmt="h5", chunk=2,
                                         device="cpu", **kw)
    assert path.name == f"Clean_{labels}_upsampled.h5"
    got = _read_h5(path)
    assert set(got) == set(want)
    with h5py.File(path, "r") as f:  # the JAX builder's layout
        assert f["X_train"].chunks == (513, 1) and f["X_train"].compression == "lzf"
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
    # the trims cut: 40 / 25 video frames, or the height 20 / 30 (legacy)
    n_train = 101 + (20 if legacy else 40)  # sa1 61 + si3 40 frames, sx2 trimmed
    assert want["X_train"].shape[1] == n_train
    for split in ("train", "validation"):
        x, w = got[f"X_{split}"], want[f"X_{split}"]
        np.testing.assert_allclose(x, w, rtol=1e-4, atol=1e-6 * w.max())
        y, wy = got[f"Y_{split}"], want[f"Y_{split}"]
        if labels == "vad_labels":
            np.testing.assert_array_equal(y, wy)
        else:
            assert (y != wy).mean() <= 1e-4
    for k in ("X_train_mean", "X_train_std"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


def test_h5_npz_and_converted_npz_are_one_frame_set(raw, tmp_path):
    """The three routes to a frame set hold the same arrays, read into the
    same datasets and train the same 2-epoch ``fit_vae`` run bitwise; the
    ``create_train_set`` CLI writes the builder's ``.npz``."""
    from dvae_tpu_torch.cli import create_train_set

    kw = dict(labels="vad_labels", proc_video_dir=raw / "videos", device="cpu")
    h5 = tbuilders.build_frame_dataset(raw / "raw", tmp_path / "a", fmt="h5", **kw)
    npz = tbuilders.build_frame_dataset(raw / "raw", tmp_path / "b", fmt="npz", **kw)
    conv = tbuilders.frames_h5_to_npz(h5, tmp_path / "conv.npz")
    assert npz.suffix == ".npz" and conv.exists()
    with np.load(npz) as a, np.load(conv) as b:
        assert set(a.files) == set(b.files) == set(_read_h5(h5))
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    runs = []
    for path in (h5, npz, conv):
        train, valid = FrameDataset(path, "train"), FrameDataset(path, "validation")
        if runs:
            for u, v in zip(train.arrays + valid.arrays, runs[0][0]):
                np.testing.assert_array_equal(u, v)
            for u, v in zip(train.mean_std, runs[0][1]):
                np.testing.assert_array_equal(u, v)
        model = VAE(513, 16, H)
        fit_vae(model, train, valid, tmp_path / f"fit_{path.stem}{path.suffix}", "M1",
                cfg=LoopConfig(batch_size=32, end_epoch=3, std_norm=True), device="cpu")
        runs.append((train.arrays + valid.arrays, train.mean_std, model.state_dict()))
    for _, _, sd in runs[1:]:
        assert all(torch.equal(v, runs[0][2][k]) for k, v in sd.items())

    data_root = tmp_path / "cli"
    (data_root / "subset").mkdir(parents=True)
    (data_root / "subset" / "raw").symlink_to(raw / "raw")
    out = create_train_set.main(["--data-root", str(data_root), "--format", "npz",
                                 "--platform", "cpu"])
    assert out == data_root / "subset/processed/ntcd_timit/Clean_vad_labels_upsampled.npz"
    with np.load(out) as a, np.load(conv) as b:
        # no video h5s under this tree's processed/: nothing is trimmed
        assert a["X_train"].shape[1] > b["X_train"].shape[1]
        assert a["X_validation"].shape[0] == 513 and a["Y_train"].shape[0] == 1


def test_streamed_frame_set_gives_jax_streamed_batches(tmp_path):
    """``in_memory=False`` streams sorted column batches from the h5 (the
    port's copy of the JAX package's out-of-core test, on a synthetic
    file): the JAX streamed batches exactly, and per batch the rows of the
    in-memory batches; ``arrays`` raises, and an ``.npz`` cannot stream."""
    rng = np.random.default_rng(3)
    path = tmp_path / "frames.h5"
    with h5py.File(path, "w") as f:
        f["X_train"] = rng.uniform(size=(513, 300)).astype(np.float32)
        f["Y_train"] = (rng.uniform(size=(1, 300)) > 0.5).astype(np.float32)
        f["X_train_mean"] = rng.uniform(size=(513, 1)).astype(np.float32)
        f["X_train_std"] = rng.uniform(size=(513, 1)).astype(np.float32)
    mem = FrameDataset(path, "train")
    ooc = FrameDataset(path, "train", in_memory=False)
    jooc = jdatasets.FrameDataset(path, "train", in_memory=False)
    assert len(ooc) == len(mem) == 300 and ooc.x_dim == mem.x_dim == 513
    for u, v in zip(ooc.mean_std, mem.mean_std):
        np.testing.assert_array_equal(u, v)

    def canon(x, y):
        xy = np.concatenate([x, y], axis=1)
        return xy[np.lexsort(xy.T[::-1])]

    batches = zip(ooc.batches(32, np.random.default_rng(7)),
                  jooc.batches(32, np.random.default_rng(7)),
                  mem.batches(32, np.random.default_rng(7)))
    for (x, y), (jx, jy), (mx, my) in batches:
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(canon(x, y), canon(mx, my))
    with pytest.raises(ValueError, match="in_memory=True"):
        ooc.arrays
    ooc.close()
    jooc.close()
    npz = tbuilders.frames_h5_to_npz(path)
    with pytest.raises(ValueError, match="stream"):
        FrameDataset(npz, "train", in_memory=False)


# ---------------------------------------------------------------------------
# the trainer CLIs against the JAX scripts
# ---------------------------------------------------------------------------

PORT_CLIS = {"training_M1": "training_m1", "training_M2": "training_m2",
             "training_M2_info_vad": "training_m2_info_vad",
             "training_M2_info_vad_pretrain": "training_m2_info_vad_pretrain",
             "training_M2v3_semisup": "training_m2v3_semisup"}
FIT_OF = {"training_M1": "fit_vae", "training_M2": "fit_vae",
          "training_M2_info_vad": "fit_adversarial",
          "training_M2_info_vad_pretrain": "fit_adversarial",
          "training_M2v3_semisup": "fit_semisup"}
# the arguments that hold objects, compared on their own
OBJECTS = {"model", "train_ds", "valid_ds", "cfg", "mesh", "device", "init_state_dict",
           "init_params_override", "init_params_fn"}


@pytest.fixture(scope="module")
def corpus(raw, tmp_path_factory):
    """A data root whose subset has both frame h5s, written by the port's
    builder, and a classifier donor for the pretrain scripts: the same
    weights as a JAX ``.msgpack`` and a port ``.pt``."""
    root = tmp_path_factory.mktemp("corpus") / "data"
    proc = root / "subset" / "processed"
    for labels in ("vad_labels", "ibm_labels"):
        tbuilders.build_frame_dataset(raw / "raw", proc, labels=labels, device="cpu")
    jm = jmodels.DisentangledVAE(x_dim=513, y_dim=1, z_dim=16, h_dim=(128, 128))
    params = jmodels.init_params(
        jm, {"params": jax.random.PRNGKey(7), "sample": jax.random.PRNGKey(8)},
        np.ones((4, 513), np.float32), np.ones((4, 1), np.float32))
    donor = jckpt.save_checkpoint(root.parent / "donor", "M2_epoch_001_vloss_1.00", params)
    pt = donor.with_suffix(".pt")
    torch.save(state_dict_from_jax(jax.device_get(params)), pt)
    return root, donor, pt


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


def _model_desc(model):
    dims = tuple(getattr(model, k, None) for k in ("x_dim", "y_dim", "z_dim"))
    return type(model).__name__, dims, tuple(model.h_dim)


def _run_jax(monkeypatch, capsys, script, argv):
    sys.path.insert(0, str(SCRIPTS))
    mod = importlib.import_module(script)
    real = getattr(jloop, FIT_OF[script])
    calls = []
    monkeypatch.setattr(jloop, FIT_OF[script],
                        lambda *a, **kw: calls.append(_call(real, a, kw)) or (None, []))
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv, "--platform", "cpu",
                                      "--no-jit-cache"])
    mod.main()
    return calls[0], capsys.readouterr().out


def _run_port(monkeypatch, capsys, script, argv):
    mod = importlib.import_module(f"dvae_tpu_torch.cli.{PORT_CLIS[script]}")
    real = getattr(mod, FIT_OF[script])
    calls = []
    monkeypatch.setattr(mod, FIT_OF[script],
                        lambda *a, **kw: calls.append(_call(real, a, kw)) or (None, []))
    mod.main([*argv, "--platform", "cpu"])
    return calls[0], capsys.readouterr().out


GRAMMARS = [
    ("training_M1", []), ("training_M1", ["--std-norm", "--end-epoch", "7", "--seed", "3"]),
    ("training_M1", ["--run-name", "m1_resume", "--start-epoch", "4", "--batch-size", "64",
                     "--steps-per-dispatch", "8", "--device-data"]),
    ("training_M1", ["--no-in-memory", "--learning-rate", "3e-4", "--log-interval", "10",
                     "--z-dim", "8", "--h-dim", "64", "32"]),
    ("training_M2", []), ("training_M2", ["--labels", "ibm_labels"]),
    ("training_M2", ["--model-variant", "v2", "--std-norm"]),
    ("training_M2", ["--model-variant", "v2", "--labels", "ibm_labels"]),
    ("training_M2v3_semisup", []),
]
GRAMMARS += [("training_M2v3_semisup", ["--objective", o, "--alpha", a, "--y-cond", c])
             for o, a, c in (("uloss", "-10", "hardlabel"), ("lloss", "10", "yhathard"),
                             ("uloss", "5", "ytrue"), ("lloss", "0", "soft"))]
GRAMMARS += [("training_M2v3_semisup", ["--labels", "ibm_labels", "--steps-per-dispatch", "4"])]
for variant in ("v5", "v4"):
    for cond in ("ytrue", "soft", "yhathard", "hardlabel"):
        GRAMMARS.append(("training_M2_info_vad", ["--model-variant", variant, "--y-cond", cond]))
    for adv in ("uniform", "entropy"):
        GRAMMARS.append(("training_M2_info_vad", ["--model-variant", variant,
                                                  "--enc-adversary", adv, "--alpha", "1",
                                                  "--beta", "2.5", "--gamma", "0"]))
GRAMMARS += [("training_M2_info_vad", ["--legacy-aux-coupling", "--std-norm",
                                       "--steps-per-dispatch", "8", "--device-data"])]
GRAMMARS += [("training_M2_info_vad_pretrain", extra) for extra in (
    [], ["--gamma", "2.0"], ["--enc-adversary", "bce", "--freeze-classifier"],
    ["--enc-adversary", "uniform", "--alpha", "1", "--beta", "3", "--legacy-aux-coupling"],
    ["--run-name", "pre", "--std-norm", "--seed", "5"])]


@pytest.mark.parametrize("script,extra", GRAMMARS,
                         ids=[f"{s}[{' '.join(e)}]" for s, e in GRAMMARS])
def test_trainer_cli_matches_jax_script(corpus, monkeypatch, capsys, jax_cache_kept,
                                        script, extra):
    root, donor, pt = corpus
    base = ["--data-root", str(root), "--models-root", "models"]
    if script.endswith("pretrain"):
        jcall, jout = _run_jax(monkeypatch, capsys, script,
                               base + extra + ["--pretrained-checkpoint", str(donor)])
        tcall, tout = _run_port(monkeypatch, capsys, script,
                                base + extra + ["--pretrained-checkpoint", str(pt)])
        want = state_dict_from_jax(jax.device_get(jcall["init_params_override"]))
        got = tcall["init_state_dict"]
        assert set(got) == set(want)
        clf = [k for k in got if k.startswith("enc_dec_clf.classifier.")]
        assert clf and all(torch.equal(got[k], want[k]) for k in clf)
    else:
        jcall, jout = _run_jax(monkeypatch, capsys, script, base + extra)
        tcall, tout = _run_port(monkeypatch, capsys, script, base + extra)
    assert tout == jout
    assert _model_desc(tcall["model"]) == _model_desc(jcall["model"])
    assert dataclasses.asdict(tcall["cfg"]) == dataclasses.asdict(jcall["cfg"])
    assert jcall["mesh"] is None and tcall["device"] == "cpu"
    for split in ("train_ds", "valid_ds"):
        assert len(tcall[split]) == len(jcall[split])
    same = {k: v for k, v in jcall.items() if k not in OBJECTS}
    assert {k: v for k, v in tcall.items() if k not in OBJECTS} == same


PARSE_ERRORS = [(s, ["--device-data", "--no-in-memory"]) for s in PORT_CLIS]
PARSE_ERRORS += [("training_M2v3_semisup", ["--std-norm"]),
                 ("training_M2", ["--model-variant", "v3"]),
                 ("training_M2_info_vad", ["--y-cond", "bogus"])]


@pytest.mark.parametrize("script,argv", PARSE_ERRORS,
                         ids=[f"{s}[{' '.join(a)}]" for s, a in PARSE_ERRORS])
def test_trainer_cli_parse_errors_match_jax(corpus, monkeypatch, capsys, jax_cache_kept,
                                            script, argv):
    root, donor, pt = corpus
    argv = ["--data-root", str(root), *argv]
    if script.endswith("pretrain"):
        argv += ["--pretrained-checkpoint", str(pt)]
    with pytest.raises(SystemExit) as jexit:
        _run_jax(monkeypatch, capsys, script, argv)
    jerr = capsys.readouterr().err
    with pytest.raises(SystemExit) as texit:
        _run_port(monkeypatch, capsys, script, argv)
    terr = capsys.readouterr().err
    assert texit.value.code == jexit.value.code == 2
    assert terr.split("error: ")[-1] == jerr.split("error: ")[-1]


@pytest.mark.parametrize("argv,said", [
    (["--data-parallel"], "the run without the flag"),
    (["--multihost"], "--multihost was requested"),
    (["--no-in-memory", "--frames", "x.npz"], "an .npz frame set is read into memory"),
])
def test_trainer_cli_refuses_what_is_not_ported(corpus, tmp_path, monkeypatch, capsys, argv,
                                                said):
    """``--data-parallel`` launched alone trains at world size 1 over the
    process's device: the run without the flag, bit for bit (two processes
    under a gloo group: tests/test_torch_port_parallel.py). ``--multihost``
    without a torchrun group of more than one process fails loudly, naming
    torchrun; a streamed ``.npz`` is a parse error."""
    from dvae_tpu_torch.cli import training_m1

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    base = ["--data-root", str(corpus[0]), "--platform", "cpu"]
    if argv == ["--data-parallel"]:
        small = [*base, "--end-epoch", "3", "--batch-size", "64", "--h-dim", "16"]
        _, hist = training_m1.main([*small, "--models-root", str(tmp_path / "plain")])
        _, hist_dp = training_m1.main([*small, "--models-root", str(tmp_path / "dp"), *argv])
        assert hist_dp == hist, said
        weights = [a for a in (tmp_path / "plain").rglob("M1_epoch_*.pt")
                   if not a.name.endswith(".opt.pt")]
        assert weights
        for a in sorted(weights):
            b = tmp_path / "dp" / a.relative_to(tmp_path / "plain")
            for k, v in torch.load(a, weights_only=True).items():
                assert torch.equal(v, torch.load(b, weights_only=True)[k]), (a.name, k)
    elif argv == ["--multihost"]:
        with pytest.raises(RuntimeError, match=said) as exc:
            training_m1.main([*base, *argv])
        assert "torchrun" in str(exc.value)
    else:
        with pytest.raises(SystemExit) as exc:
            training_m1.main([*base, *argv])
        assert exc.value.code == 2 and said in capsys.readouterr().err


def test_trainer_cli_trains_on_an_npz_frame_set(corpus, tmp_path, capsys):
    """The whole CLI path on the CPU: ``--frames`` an ``.npz`` converted
    from the corpus h5, two epochs at K = 4, one checkpoint per epoch under
    the mangled run name."""
    from dvae_tpu_torch.cli import training_m2

    root = corpus[0]
    npz = tbuilders.frames_h5_to_npz(
        root / "subset/processed/ntcd_timit/Clean_vad_labels_upsampled.h5", tmp_path / "f.npz")
    best, hist = training_m2.main(["--frames", str(npz), "--models-root", str(tmp_path),
                                   "--end-epoch", "3", "--batch-size", "16",
                                   "--steps-per-dispatch", "4", "--h-dim", "32", "32",
                                   "--platform", "cpu"])
    run = tmp_path / "ntcd_M2_VAD_nonorm_hdim_032_032_zdim_016_end_epoch_003"
    assert len(list(run.glob("M2_epoch_*_vloss_*.opt.pt"))) == 2
    assert all(np.isfinite(h["valid"]["elbo"]) for h in hist)
    assert "training ntcd_M2_VAD_nonorm" in capsys.readouterr().out


def test_norm_stats_read_from_either_frame_set(corpus, tmp_path):
    """``--std-norm``'s statistics (``--norm-h5``) come from an ``.npz``
    frame set too, equal to the ``.h5``'s, so the card reads them without
    ``h5py``."""
    from dvae_tpu_torch.cli._family import read_norm_stats

    h5 = corpus[0] / "subset/processed/ntcd_timit/Clean_ibm_labels_upsampled.h5"
    npz = tbuilders.frames_h5_to_npz(h5, tmp_path / "f.npz")
    for u, v in zip(read_norm_stats(npz), read_norm_stats(h5)):
        assert u.shape == (513, 1)
        np.testing.assert_array_equal(u, v)
