"""Port parity: the audio builders, the noise catalogs and the label and
video readers against the JAX package's.

* ``build_audio_train_set`` on a synthetic raw tree (``_ntcd_tree.
  make_raw_tree``: clean wavs of three splits and their noisy mixtures at
  Babble and LR -5 dB, plus LR 15 dB, which lies on the pair grid but not
  on the copy grid; a lip video for every train utterance): the same
  files, the copied wavs byte for byte, the VAD labels exactly and the IBM
  labels on all but at most 1e-4 of the bins. The noisy statistics at
  rtol 5e-4, and on all but 1% of the bins at rtol 1e-5. The JAX builder
  sums in float32 and the port in float64, which moves neither by more
  than ~4e-7 here; the larger gap of a few bins is the log power itself:
  each package's f32 matmul DFT rounds a frame's low-power bin its own
  way, and each package's std lies up to ~2.4e-4 from that of a float64
  DFT of the same mixtures (measured on this tree, bin 128).
* ``fmt="npz"`` with ``.npz`` videos against ``fmt="h5"`` with ``.h5``
  videos: the same arrays. The raises of both builders: a train mixture
  without its video, a wav at another rate.
* ``copy_ntcd_noisy_test``, ``build_qut_test_set`` (byte-identical
  triplets and pickle, the same raises) and the ``qut`` / ``demand``
  catalogs.
* The readers: a tree of ``.npz`` label files and videos gives the sweep
  the items, labels and trims of the same tree in ``.h5``; a tree with
  both gives each utterance once; an ``.h5`` without ``h5py`` is an error
  that names the ``.npz`` route.
"""

import pickle
import sys

import h5py
import numpy as np
import pytest

import dvae_tpu.data.builders as jbuilders
import dvae_tpu.data.catalog.demand as jdemand
import dvae_tpu.data.catalog.ntcd_timit as jcat
import dvae_tpu.data.catalog.qut as jqut
import dvae_tpu.enhance.evaluate as jev
import dvae_tpu_torch.data.catalog.demand as tdemand
import dvae_tpu_torch.data.catalog.ntcd_timit as tcat
import dvae_tpu_torch.data.catalog.qut as tqut
import dvae_tpu_torch.enhance.evaluate as tev
from dvae_tpu_torch.data import builders as tbuilders
from dvae_tpu_torch.data import io as tio
from dvae_tpu_torch.data.datasets import UtteranceDataset
from _ntcd_tree import AUDIO_VIDEOS, NOISY_DIR, RAW_UTTS, make_raw_tree, make_tree, write_videos
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

AUDIO_UTTS = dict(RAW_UTTS, test={("spk04", "sa1"): 12000, ("spk04", "sx5"): 17600})
NOISY = [("Babble", "-5"), ("LR", "-5"), ("LR", "15")]
STATS = tbuilders.NOISY_STATS


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio_raw") / "raw"
    make_raw_tree(root, utts=AUDIO_UTTS, noisy=NOISY)
    return root


def _files(root):
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def _arrays(path):
    if path.suffix == ".npz":
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}


@pytest.mark.parametrize("labels", ["vad_labels", "ibm_labels"])
def test_build_audio_train_set_matches_jax(raw, tmp_path, labels):
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    for out in (jax_out, port_out):
        write_videos(out, AUDIO_VIDEOS)
    assert jbuilders.build_audio_train_set(raw, jax_out, labels=labels) is None
    stats = tbuilders.build_audio_train_set(raw, port_out, labels=labels, chunk=2,
                                            device="cpu")
    assert stats == port_out / f"{STATS}.h5"
    want, got = _files(jax_out), _files(port_out)
    assert got.keys() == want.keys()
    n_utts = sum(len(u) for u in AUDIO_UTTS.values())
    wavs = [k for k in got if k.endswith(".wav")]
    noisy = [k for k in wavs if "/Noisy/" in k]
    # every clean wav, and the -5 dB mixtures; the 15 dB ones are skipped
    assert len(wavs) == 3 * n_utts and len(noisy) == 2 * n_utts
    assert not any("/15/" in k for k in noisy)
    labels_files = [k for k in got if k.endswith(f"_{labels}_upsampled.h5")]
    assert len(labels_files) == n_utts
    for k in wavs:
        assert got[k].read_bytes() == want[k].read_bytes(), k
    for k in labels_files:
        y, wy = _arrays(got[k])["Y"], _arrays(want[k])["Y"]
        assert y.dtype == np.float32 and y.shape == wy.shape, k
        # over all of the utterance's frames, untrimmed by its video
        assert y.shape[0] == (1 if labels == "vad_labels" else 513)
        if labels == "vad_labels":
            np.testing.assert_array_equal(y, wy)
        else:
            assert (y != wy).mean() <= 1e-4
    s, ws = _arrays(got[f"{STATS}.h5"]), _arrays(want[f"{STATS}.h5"])
    for k in ("X_train_mean", "X_train_std"):
        assert s[k].shape == ws[k].shape == (513, 1) and s[k].dtype == np.float32
        np.testing.assert_allclose(s[k], ws[k], rtol=5e-4)
        assert (np.abs(s[k] - ws[k]) > 1e-5 * np.abs(ws[k])).mean() <= 0.01


def test_npz_route_gives_the_h5_arrays(raw, tmp_path):
    """``fmt="npz"`` over ``.npz`` videos writes, under the same names with
    the other suffix, the arrays ``fmt="h5"`` writes over ``.h5`` videos."""
    write_videos(tmp_path / "h5", AUDIO_VIDEOS, "h5")
    write_videos(tmp_path / "npz", AUDIO_VIDEOS, "npz")
    kw = dict(dataset_types=("train", "test"), dataset_size="subset", device="cpu")
    tbuilders.build_audio_train_set(raw, tmp_path / "h5", **kw)
    stats = tbuilders.build_audio_train_set(raw, tmp_path / "npz", fmt="npz", chunk=3, **kw)
    assert stats == tmp_path / "npz" / f"{STATS}.npz"
    h5s = {k: p for k, p in _files(tmp_path / "h5").items() if "/matlab_raw/" not in k}
    npzs = {k: p for k, p in _files(tmp_path / "npz").items() if "/matlab_raw/" not in k}
    assert {k.replace(".h5", ".npz") for k in h5s} == set(npzs)
    for k, p in h5s.items():
        if k.endswith(".wav"):
            assert p.read_bytes() == npzs[k].read_bytes()
            continue
        a, b = _arrays(p), _arrays(npzs[k.replace(".h5", ".npz")])
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])


def _one_utt_tree(root, rate=16000):
    utts = {"train": {("spk01", "sa1"): 16000}}
    make_raw_tree(root, utts=utts, noisy=[("Babble", "-5")])
    if rate != 16000:
        from dvae_tpu_torch.data.io import write_wav

        write_wav(root / NOISY_DIR / "Babble/-5/volunteers/spk01/straightcam/sa1.wav",
                  np.zeros(8000), rate)


@pytest.mark.parametrize("fault", ["missing video", "sample rate"])
def test_audio_builders_raise_alike(tmp_path, fault):
    """A train mixture without its clean utterance's lip video (no
    untrimmed fallback) or at another rate than 16 kHz raises in both."""
    raw = tmp_path / "raw"
    _one_utt_tree(raw, 8000 if fault == "sample rate" else 16000)
    if fault == "sample rate":
        for side in ("jax", "port"):
            write_videos(tmp_path / side, {("train", "spk01", "sa1"): (2, 2, 9)})
    err, match = ((FileNotFoundError, None) if fault == "missing video"
                  else (ValueError, "Unexpected sampling rate 8000"))
    with pytest.raises(err, match=match):
        jbuilders.build_audio_train_set(raw, tmp_path / "jax", dataset_types=("train",))
    with pytest.raises(err, match=match):
        tbuilders.build_audio_train_set(raw, tmp_path / "port", dataset_types=("train",),
                                        fmt="npz", device="cpu")


@pytest.mark.parametrize("size", ["subset", "complete"])
def test_copy_ntcd_noisy_test_matches_jax(raw, tmp_path, size):
    n = jbuilders.copy_ntcd_noisy_test(raw, tmp_path / "jax", "test", size)
    assert tbuilders.copy_ntcd_noisy_test(raw, tmp_path / "port", "test", size) == n
    # the test split's two utterances at Babble and LR -5 dB; 15 dB is off the grid
    assert n == 4
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert got.keys() == want.keys() and len(got) == n
    assert all(got[k].read_bytes() == want[k].read_bytes() for k in got)


def _noise_dir(root, keys=("cafe", "home", "street", "car"), rate=16000, seconds=3.0,
               split="train"):
    """Preprocessed QUT noise wavs, ``<root>/<split>/.../<type>.wav``."""
    from dvae_tpu_torch.data.io import write_wav

    rng = np.random.default_rng(5)
    for k in keys:
        d = root / split / ("a" if k in ("cafe", "car") else "b")
        d.mkdir(parents=True, exist_ok=True)
        write_wav(d / f"{k}.wav", 0.3 * rng.standard_normal(int(seconds * rate)), rate)
    return root


def test_build_qut_test_set_matches_jax_byte_for_byte(raw, tmp_path):
    """Both builders reseed numpy's global RNG, so they run one after the
    other: the same noise types and SNRs, the same crops, the same bytes."""
    noise = _noise_dir(tmp_path / "noise")
    snrs = (-5.0, 0.0, 5.0)
    want = jbuilders.build_qut_test_set(raw, noise, tmp_path / "jax", "train", snrs, seed=3)
    got = tbuilders.build_qut_test_set(raw, noise, tmp_path / "port", "train", snrs, seed=3)
    assert got == want and len(got) == len(AUDIO_UTTS["train"])
    jf, tf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert tf.keys() == jf.keys() and len(tf) == 3 * len(got) + 1
    assert all(tf[k].read_bytes() == jf[k].read_bytes() for k in tf)
    with open(tf["train_snr_db.p"], "rb") as f:
        assert pickle.load(f) == got


@pytest.mark.parametrize("fault,err", [("rate", ValueError), ("none", FileNotFoundError),
                                       ("absent type", KeyError)])
def test_build_qut_test_set_raises_alike(raw, tmp_path, fault, err):
    if fault == "rate":
        noise = _noise_dir(tmp_path / "noise", rate=8000)
    elif fault == "none":
        noise = tmp_path / "empty"
    else:  # only cafe noise: one of the three utterances draws another type
        noise = _noise_dir(tmp_path / "noise", keys=("cafe",))
    for side, build in (("jax", jbuilders), ("port", tbuilders)):
        with pytest.raises(err):
            build.build_qut_test_set(raw, noise, tmp_path / side, "train", seed=0)


def test_noise_catalogs_match_jax(tmp_path):
    from dvae_tpu_torch.data.io import write_wav

    qdir = tmp_path / "qut"
    for name in ("CAFE-CAFE-1.wav", "CAR-WINDOWNB-1.wav", "HOME-KITCHEN-1.wav",
                 "STREET-CITY-1.wav", "OTHER.wav"):
        (qdir / "sub").mkdir(parents=True, exist_ok=True)
        write_wav(qdir / "sub" / name, np.zeros(16), 16000)
    assert tqut.noise_list(str(qdir)) == jqut.noise_list(str(qdir))
    assert len(tqut.noise_list(str(qdir))) == 4
    prep = _noise_dir(tmp_path / "prep", split="test")
    assert tqut.noise_list_preprocessed(str(prep)) == jqut.noise_list_preprocessed(str(prep))
    ddir = tmp_path / "demand"
    for folder in ("DWASHING", "NRIVER", "OOFFICE", "TMETRO", "NFIELD", "PSTATION"):
        for ch in (1, 2):
            (ddir / folder).mkdir(parents=True, exist_ok=True)
            write_wav(ddir / folder / f"ch{ch:02d}.wav", np.zeros(16), 16000)
    for split in ("train", "validation"):
        assert tdemand.noise_list(str(ddir), split) == jdemand.noise_list(str(ddir), split)
        d = tmp_path / "dprep" / tdemand._PREPROCESSED_SPLIT_DIRS[split] / "x"
        d.mkdir(parents=True)
        write_wav(d / "n1.wav", np.zeros(16), 16000)
        assert tdemand.noise_list_preprocessed(str(tmp_path / "dprep"), split) == \
            jdemand.noise_list_preprocessed(str(tmp_path / "dprep"), split)
    for mod in (tqut, jqut):
        with pytest.raises(NotImplementedError):
            mod.noise_list(str(qdir), "train")
    for mod in (tdemand, jdemand):
        with pytest.raises(NotImplementedError):
            mod.noise_list(str(ddir), "test")
        with pytest.raises(NotImplementedError):
            mod.noise_list_preprocessed(str(ddir), "test")

    rng = np.random.default_rng(0)
    stereo = rng.standard_normal((48000 * 2, 2))
    for key in ("car", "cafe"):
        np.testing.assert_array_equal(tqut.preprocess_noise(stereo, key, 48000, 16000),
                                      jqut.preprocess_noise(stereo, key, 48000, 16000))
    np.testing.assert_array_equal(tdemand.preprocess_noise(stereo, 48000, 16000),
                                  jdemand.preprocess_noise(stereo, 48000, 16000))
    audios, speech = {"cafe": rng.standard_normal(5000)}, np.zeros(700)
    for t, j in ((tqut, jqut), (tdemand, jdemand)):
        np.testing.assert_array_equal(
            t.noise_segment(audios, "cafe", speech, np.random.default_rng(4)),
            j.noise_segment(audios, "cafe", speech, np.random.default_rng(4)))
    with pytest.raises(KeyError):
        tqut.noise_segment(audios, "car", speech)


# ---------------------------------------------------------------------------
# the readers on either suffix
# ---------------------------------------------------------------------------


def _to_npz(proc, keep_h5: bool):
    """Each label and video ``.h5`` under ``proc`` as the ``.npz`` of the
    same arrays, the ``.h5`` kept or removed."""
    for p in sorted(proc.rglob("*.h5")):
        tio.save_arrays(p.with_suffix(".npz"), _arrays(p))
        if not keep_h5:
            p.unlink()


@pytest.mark.parametrize("labels", ["vad_labels", "ibm_labels"])
def test_npz_label_tree_gives_the_h5_sweep(tmp_path, labels):
    """The catalog, the label reader, the video trims and both sweeps' batches
    of a tree of ``.npz`` files equal those of the same tree in ``.h5``; with
    both suffixes beside each other every utterance comes once, the ``.h5``
    as in the JAX catalog."""
    trees = {}
    for kind in ("h5", "npz", "both"):
        make_tree(tmp_path / kind, video=True)
        if kind != "h5":
            _to_npz(tmp_path / kind / "data", keep_h5=kind == "both")
        trees[kind] = tmp_path / kind / "data/subset/processed"
    items = {k: list(tcat.proc_noisy_clean_pair_dict(str(p) + "/", "test", "subset", labels,
                                                     True).items())
             for k, p in trees.items()}
    want = list(jcat.proc_noisy_clean_pair_dict(str(trees["h5"]) + "/", "test", "subset",
                                                labels, True).items())
    assert items["h5"] == items["both"] == want and len(want) == 10
    assert [(n, c.replace(".h5", ".npz")) for n, c in want] == items["npz"]
    clean = [c for _, c in items["npz"]]
    assert tev.video_frame_counts(trees["npz"], clean, labels) == \
        jev.video_frame_counts(trees["h5"], [c for _, c in want], labels)
    assert all(n is not None for n in tev.video_frame_counts(trees["npz"], clean, labels))
    for (_, c), (_, jc) in zip(items["npz"], want):
        np.testing.assert_array_equal(tev.load_oracle_labels(trees["npz"] / c),
                                      jev.load_oracle_labels(trees["h5"] / jc))
    ds = UtteranceDataset([(trees["npz"] / n, trees["npz"] / c) for n, c in items["npz"]])
    hs = UtteranceDataset([(trees["h5"] / n, trees["h5"] / c) for n, c in want])
    for i in range(len(ds)):
        for a, b in zip(ds[i], hs[i]):
            np.testing.assert_array_equal(a, b)

    from test_torch_port_evaluate import Recorder, _same_batches

    recs = {}
    for name, ev, proc in (("jax", jev, trees["h5"]), ("port", tev, trees["npz"])):
        rec = Recorder("none")
        kw = dict(key=None) if name == "jax" else dict(seed=0)
        ev.evaluate_sweep(rec, proc, tmp_path / f"out_{name}", dataset_size="subset",
                          labels=labels, snr_filter=None, batch_size=3,
                          y_loader=lambda n, c, ev=ev, proc=proc: ev.load_oracle_labels(proc / c),
                          log=lambda _: None, **kw)
        recs[name] = rec.batches
    _same_batches(recs["jax"], recs["port"])


def test_h5_without_h5py_names_the_npz_route(tmp_path, monkeypatch):
    path = tmp_path / "a_vad_labels_upsampled.h5"
    tio.write_labels(path, np.ones((1, 5)))
    tio.write_labels(path.with_suffix(".npz"), np.ones((1, 5)))
    video = tmp_path / "a_upsampled.h5"
    tio.save_arrays(video, {"X": np.zeros((3, 4, 7), np.float32)})
    monkeypatch.setitem(sys.modules, "h5py", None)
    for read in (tio.read_labels, tev.load_oracle_labels, tio.video_frames):
        with pytest.raises(RuntimeError, match=r"needs h5py.*\.npz"):
            read(path if read is not tio.video_frames else video)
    with pytest.raises(RuntimeError, match="needs h5py"):
        tbuilders.build_audio_train_set(tmp_path, tmp_path / "out", device="cpu")
    np.testing.assert_array_equal(tio.read_labels(path.with_suffix(".npz")), np.ones((1, 5)))
    tio.save_arrays(video.with_suffix(".npz"), {"X": np.zeros((3, 4, 7), np.float32)})
    video.unlink()
    assert tio.video_frames(video) == 7 and tio.video_frames(video, legacy=True) == 3
    assert tio.video_frames(tmp_path / "none_upsampled.h5") is None
    with pytest.raises(ValueError, match="expected one of"):
        tio.read_labels(tmp_path / "a.txt")
