"""The port's NTCD-TIMIT catalog and evaluation sweep against the JAX ones.

Over a synthetic processed tree (``_ntcd_tree.make_tree``: clean wavs,
label h5s written with ``h5py``, noisy mixtures of the subset grid, and
lip-video h5s for the trim): the catalog's path lists, the label and
frame-count readers and the shard slices equal the JAX package's; both
``evaluate_sweep``s, driven by one recording stand-in enhancer, hand it
the same batches (waveforms, labels, frame caps, clean waveforms) and
write the same files with the same contents. With the port's real
``Enhancer`` on the CPU: shards partition the list, resume-by-skip
enhances nothing twice, and each ``n_est`` is written before its
``s_est``.
"""

import types

import numpy as np
import pytest
import torch

import dvae_tpu.data.catalog.ntcd_timit as jcat
import dvae_tpu.enhance.evaluate as jev
import dvae_tpu_torch.data.catalog.ntcd_timit as tcat
import dvae_tpu_torch.enhance.evaluate as tev
from dvae_tpu_torch.enhance.mcem import McemConfig
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.models import VAE
from _ntcd_tree import UTTS, make_tree
from _torch_port import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def tree(tmp_path):
    make_tree(tmp_path, video=True)
    # video inventory for the .mat-keyed builders, and a kaldi pair
    for (spk, utt) in UTTS:
        mat = tmp_path / "data/subset/processed/ntcd_timit/matlab_raw/test" / spk / f"{utt}.mat"
        mat.touch()
    kaldi = tmp_path / "data/subset/processed/ntcd_timit/kaldi_fMLLR/test/spk01"
    kaldi.mkdir(parents=True)
    (kaldi / "a.ark").touch()
    (kaldi / "a.scp").touch()
    return tmp_path


def proc_of(tree):
    return tree / "data" / "subset" / "processed"


@pytest.mark.parametrize("size", ["subset", "complete"])
def test_catalog_copy_matches_jax(tree, size):
    d = str(proc_of(tree)) + "/"
    for name in ("video_list", "kaldi_list", "speech_list"):
        assert getattr(tcat, name)(d, "test") == getattr(jcat, name)(d, "test"), name
    for name in ("noisy_speech_dict", "noisy_clean_pair_dict"):
        assert getattr(tcat, name)(d, "test", size) == getattr(jcat, name)(d, "test", size)
    for labels in ("vad_labels", "ibm_labels"):
        for up in (False, True):
            assert tcat.proc_noisy_clean_pair_dict(d, "test", size, labels, up) == \
                jcat.proc_noisy_clean_pair_dict(d, "test", size, labels, up)
        for kw in (dict(upsampled=True), dict(dct=True), {}):
            assert tcat.proc_video_audio_pair_dict(d, "test", labels, **kw) == \
                jcat.proc_video_audio_pair_dict(d, "test", labels, **kw)
    pairs = tcat.proc_noisy_clean_pair_dict(d, "test", size, "vad_labels", True)
    # the grid's names whether or not the mixtures exist: 2 x 1 or 6 x 5
    assert len(pairs) == (2 if size == "subset" else 30) * len(UTTS)
    rel = "ntcd_timit/Clean/test/spk01/sa1_vad_labels_upsampled.h5"
    assert tcat.video_h5_rel(rel) == jcat.video_h5_rel(rel)
    assert tcat.label_h5_rel(tcat.video_h5_rel(rel)) == rel
    with pytest.raises(ValueError, match="unknown dataset_type"):
        tcat.video_list(d, "eval")


def test_readers_and_shards_match_jax(tree, tmp_path):
    proc = proc_of(tree)
    rels = sorted(tcat.proc_noisy_clean_pair_dict(str(proc) + "/", "test", "subset",
                                                  "vad_labels", True).values())
    for labels in ("vad_labels", "ibm_labels"):
        h5s = [r.replace("vad_labels", labels) for r in rels]
        for r in h5s:
            np.testing.assert_array_equal(tev.load_oracle_labels(proc / r),
                                          jev.load_oracle_labels(proc / r))
            assert tev.clean_audio_rel(r, labels) == jev.clean_audio_rel(r, labels)
        assert tev.video_frame_counts(proc, h5s, labels) == jev.video_frame_counts(proc, h5s, labels)
    assert tev.video_frame_counts(tmp_path, rels, "vad_labels") == [None] * len(rels)
    for n_items in (0, 1, 7, 10):
        for n in (1, 2, 3, 4):
            items = list(range(n_items))
            parts = [tev.shard_slice(items, (k, n)) for k in range(n)]
            assert parts == [jev.shard_slice(items, (k, n)) for k in range(n)]
            assert sum(parts, []) == items
    assert tev.shard_slice([1, 2], None) == [1, 2]
    with pytest.raises(ValueError, match="out of range"):
        tev.shard_slice([1, 2], (2, 2))


@pytest.mark.parametrize("shape,y_dim", [((40,), None), ((1, 40), None), ((40, 1), 1),
                                         ((40, 513), 513), ((513, 40), 513), ((513,), 513),
                                         ((3, 40), None)])
@pytest.mark.parametrize("ext", [".pt", ".npy"])
def test_classifier_labels_match_jax(tmp_path, shape, y_dim, ext):
    y = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    for spk_dir in ("spk01", "Noisy/LR/-5/test/spk01", "deep/split/spk02"):
        (tmp_path / spk_dir).mkdir(parents=True, exist_ok=True)
    path = tmp_path / "spk01" / f"sa1_y_hat_hard{ext}"
    torch.save(torch.from_numpy(y), path) if ext == ".pt" else np.save(path, y)
    got = tev.load_classifier_labels(path, y_dim)
    np.testing.assert_array_equal(got, jev.load_classifier_labels(path, y_dim))
    np.testing.assert_array_equal(tev.find_classifier_labels(tmp_path, "spk01", "sa1", y_dim),
                                  got)
    # the condition-mirrored file wins over the speaker's; a deeper one is found
    mirrored = tmp_path / "Noisy/LR/-5/test/spk01" / "sa1_y_hat_hard.npy"
    np.save(mirrored, np.zeros(shape, np.float32))
    rel = "Noisy/LR/-5/test/spk01"
    assert tev.classifier_label_candidates(tmp_path, "spk01", "sa1", rel) == \
        jev.classifier_label_candidates(tmp_path, "spk01", "sa1", rel)
    np.testing.assert_array_equal(
        tev.find_classifier_labels(tmp_path, "spk01", "sa1", y_dim, rel),
        jev.find_classifier_labels(tmp_path, "spk01", "sa1", y_dim, rel))
    np.save(tmp_path / "deep/split/spk02" / "si3_y_hat_hard.npy", y)
    np.testing.assert_array_equal(tev.find_classifier_labels(tmp_path, "spk02", "si3", y_dim),
                                  jev.find_classifier_labels(tmp_path, "spk02", "si3", y_dim))
    with pytest.raises(FileNotFoundError):
        tev.find_classifier_labels(tmp_path, "spk09", "sa1", y_dim)


class Recorder:
    """A stand-in enhancer for both packages' sweeps: records each batch it
    is handed and returns (0.5 x, 0.5 x - 0.01) per utterance."""

    def __init__(self, ablation):
        self.cfg = types.SimpleNamespace(ablation=ablation, stft=types.SimpleNamespace(fs=16000))
        self.batches = []

    def enhance_stream(self, batches, key=None, seed=None):
        for wavs, ys, mf, cleans in batches:
            self.batches.append((wavs, ys, mf, cleans))
            yield [(0.5 * w, 0.5 * w - 0.01) for w in wavs]


def _tree_files(root):
    from dvae_tpu_torch.data.io import read_wav

    return {str(p.relative_to(root)): read_wav(p)[0] for p in sorted(root.rglob("*.wav"))}


def _same_batches(a, b):
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        for xa, xb in zip(ba, bb):
            if xa is None or xb is None:
                assert xa is None and xb is None
            elif isinstance(xa[0], (int, np.integer)):
                assert list(xa) == list(xb)
            else:
                assert len(xa) == len(xb)
                for ua, ub in zip(xa, xb):
                    np.testing.assert_array_equal(ua, ub)


@pytest.mark.parametrize("ablation,snr,labels,with_y,shard", [
    ("none", "-5", "vad_labels", False, None),
    ("clean_z_nomcem", None, "vad_labels", True, (1, 3)),
    ("clean_z", "-5", "ibm_labels", True, (0, 2)),
    ("none", "10", "vad_labels", False, None),
])
def test_evaluate_sweep_matches_jax(tree, tmp_path, ablation, snr, labels, with_y, shard):
    proc = proc_of(tree)
    outs, recs = {}, {}
    for name, ev in (("jax", jev), ("port", tev)):
        rec = Recorder(ablation)
        y_loader = (lambda noisy, clean: ev.load_oracle_labels(proc / clean)) if with_y else None
        kw = dict(key=None) if name == "jax" else dict(seed=0)
        n = ev.evaluate_sweep(rec, proc, tmp_path / name, dataset_size="subset", labels=labels,
                              snr_filter=snr, batch_size=3, y_loader=y_loader,
                              suffix="_y_hat_soft" if with_y else "", shard=shard,
                              log=lambda _: None, **kw)
        outs[name], recs[name] = (n, _tree_files(tmp_path / name)), rec.batches
    _same_batches(recs["jax"], recs["port"])
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][1].keys() == outs["jax"][1].keys()
    for k, v in outs["jax"][1].items():
        np.testing.assert_array_equal(outs["port"][1][k], v)
    if snr == "10":
        assert outs["port"][0] == 0
    else:
        assert outs["port"][0] > 0
        prefix = "" if ablation == "none" else "_" + ablation
        suffix = "_y_hat_soft" if with_y else ""
        assert all(k.endswith((f"{prefix}_s_est{suffix}.wav", f"{prefix}_n_est{suffix}.wav"))
                   for k in outs["port"][1])


def test_sweep_with_the_enhancer_shards_and_resumes(tree, tmp_path, monkeypatch):
    """The port's Enhancer on the CPU: the two shards together write every
    pair once; a whole run then enhances nothing; a lost s_est is redone
    alone; each n_est is written before its s_est."""
    proc = proc_of(tree)
    quick = McemConfig(niter=1, nsamples_e_step=1, burnin_e_step=1, nsamples_wf=1,
                       burnin_wf=1, nmf_rank=2)
    enh = Enhancer(VAE(513, 16, (8, 8)), EnhancerConfig(mcem=quick), device="cpu")
    order = []
    real_write = tev.write_wav
    monkeypatch.setattr(tev, "write_wav", lambda p, d, fs: (order.append(p.name),
                                                            real_write(p, d, fs)))

    def sweep(**kw):
        return tev.evaluate_sweep(enh, proc, tmp_path / "out", dataset_size="subset",
                                  snr_filter="-5", batch_size=4, log=lambda _: None, **kw)

    n_all = 2 * len(UTTS)
    assert sweep(shard=(0, 2)) + sweep(shard=(1, 2)) == n_all
    files = sorted(p.relative_to(tmp_path / "out") for p in (tmp_path / "out").rglob("*.wav"))
    assert len(files) == 2 * n_all
    assert all(a.endswith("_n_est.wav") and b == a.replace("_n_est", "_s_est")
               for a, b in zip(order[::2], order[1::2]))
    stamps = {p: p.stat().st_mtime_ns for p in (tmp_path / "out").rglob("*.wav")}
    assert sweep() == 0
    lost = tmp_path / "out" / files[1]
    assert lost.name.endswith("_s_est.wav")
    lost.unlink()
    assert sweep() == 1
    assert stamps.keys() == {p for p in (tmp_path / "out").rglob("*.wav")}
