"""``dvae_tpu_torch.cli.av_fusion_study`` against the JAX package's
``scripts/av_fusion_study.py``.

Tier 1: the port's F1 / precision / recall against the JAX script's
``f1_prec_rec``; a ``--snr`` off the catalog's grid refused before any
process runs; and the report (per-condition F1, the budgets read from the
checkpoints, the checkpoint names) assembled by both on the same planted
prediction, label and checkpoint files of a ``tests/_ntcd_tree.py`` tree,
with every step's process stood in for, key for key and value for value
but the date. Slow: both studies end to end at toy budgets on one
synthetic tree (``--epochs 2 --hidden 8``), their JSON key for key.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from dvae_tpu_torch.cli import av_fusion_study
from dvae_tpu_torch.data import builders as tbuilders
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped
from _ntcd_tree import UTTS, make_raw_tree, make_tree, write_lip_mats
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_video_cli import UTTS as RAW_UTTS

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "av_fusion_study.py"


@pytest.fixture(scope="module")
def jax_study():
    spec = importlib.util.spec_from_file_location("jax_av_fusion_study", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_f1_prec_rec_matches_jax_script(jax_study):
    rng = np.random.default_rng(0)
    for n, p in ((1000, 0.5), (333, 0.9), (50, 0.05)):
        pred = (rng.uniform(size=n) < p).astype(np.int32)
        ref = (rng.uniform(size=n) < 0.6).astype(np.int32)
        np.testing.assert_allclose(av_fusion_study.f1_prec_rec(pred, ref),
                                   jax_study.f1_prec_rec(pred, ref), rtol=1e-6)


def test_non_grid_snr_fails_before_any_process(tmp_path, monkeypatch):
    def no_process(*a, **kw):
        raise AssertionError("a step ran")

    monkeypatch.setattr(av_fusion_study, "run", no_process)
    with pytest.raises(SystemExit, match="catalog's subset grid") as exc:
        av_fusion_study.main(["--data-root", str(tmp_path), "--models-root", str(tmp_path),
                              "--train", "--snr", "0", "--out", str(tmp_path / "x.json")])
    assert "-5" in str(exc.value)


def _plant(root, tag: str, epochs: dict, seed=0):
    """Model dirs with per-epoch checkpoint metadata and the three
    modalities' hard predictions, as the trainers and predict_vad_labels
    leave them."""
    rng = np.random.default_rng(seed)
    models = root / "models"
    hl = "8x1"
    names = {"audio": f"ntcd_audio_vad_lstm_{hl}_norm{tag}",
             "video": f"ntcd_video_vad_{hl}_norm{tag}", "av": f"ntcd_av_vad_{hl}_norm{tag}"}
    for modality, name in names.items():
        d = models / name
        d.mkdir(parents=True)
        for e in range(1, epochs[modality] + 1):
            bce = float(rng.uniform(0.3, 0.7))
            (d / f"VAD_epoch_{e:03d}_vloss_{bce:.2f}.json").write_text(json.dumps(
                {"epoch": e, "bce": bce, "valid_bce": bce,
                 "valid_f1": float(rng.uniform(0.4, 0.9))}))
    preds = models / f"av_study_preds{tag}"
    for (spk, utt), n in UTTS.items():
        frames = n_stft_frames_clamped(n, StftConfig())
        for modality in names:
            rels = ([f"ntcd_timit/Clean/test/{spk}"] if modality == "video" else
                    [f"ntcd_timit/Noisy/{noise}/-5/test/{spk}" for noise in ("Babble", "LR")])
            for rel in rels:
                out = preds / modality / rel
                out.mkdir(parents=True, exist_ok=True)
                m = frames + int(rng.integers(-2, 3))
                np.save(out / f"{utt}_y_hat_hard.npy",
                        (rng.uniform(size=(m, 1)) > 0.45).astype(np.float32))
    return models


@pytest.mark.parametrize("tag,epochs", [("_p", {"audio": 3, "video": 3, "av": 3}),
                                        ("", {"audio": 2, "video": 4, "av": 3})],
                         ids=["tagged-matched", "untagged-mismatched"])
def test_report_matches_jax_script_on_planted_files(tmp_path, monkeypatch, capsys, jax_study,
                                                    tag, epochs):
    make_tree(tmp_path)
    models = _plant(tmp_path, tag, epochs)
    argv = ["--data-root", str(tmp_path / "data"), "--models-root", str(models),
            "--hidden", "8", "--num-layers", "1", "--emb-dim", "4", "--epochs", "9",
            *(["--run-tag", tag[1:]] if tag else [])]
    ran = {"jax": [], "port": []}
    monkeypatch.setattr(jax_study, "run", lambda a, **kw: ran["jax"].append(a))
    monkeypatch.setattr(sys, "argv", ["av_fusion_study.py", *argv, "--platform", "cpu",
                                      "--out", str(tmp_path / "jax.json")])
    jax_study.main()
    jtables = capsys.readouterr().out
    monkeypatch.setattr(av_fusion_study, "run", lambda m, a: ran["port"].append((m, a)))
    got = av_fusion_study.main([*argv, "--platform", "cpu", "--out", str(tmp_path / "t.json")])
    ttables = capsys.readouterr().out
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(json.dumps(got))
    for d in (got, want):
        del d["protocol"]["date"]
    assert json.loads(json.dumps(got)) == want
    assert want["f1_per_condition"]["av"]["Babble/-5"]["f1"] > 0
    assert (want["protocol"]["budgets"]["epochs"] is None) == bool(not tag)

    def tables(out):
        return out.split("| condition |")[1].split("\nwrote ")[0]

    # the same markdown tables, and one predict step per modality each
    assert tables(ttables) == tables(jtables)
    assert [m for m, _ in ran["port"]] == ["predict_vad_labels"] * 3 == \
        [pathlib.Path(str(a[0])).stem for a in ran["jax"]]


@pytest.mark.slow
def test_study_end_to_end_matches_jax_script_keys(tmp_path):
    """Both studies train, predict and report at toy budgets on one
    synthetic tree (the port's builders wrote it as ``.h5``, which both
    read): the same JSON keys everywhere, the same protocol, budgets from
    the checkpoints."""
    data = tmp_path / "data"
    raw, proc = data / "subset" / "raw", data / "subset" / "processed"
    make_raw_tree(raw, utts=RAW_UTTS, noisy=[("Babble", "-5"), ("LR", "-5")])
    write_lip_mats(raw, RAW_UTTS)
    tbuilders.build_video_files(raw, proc, device="cpu")
    tbuilders.build_audio_train_set(raw, proc, dataset_size="subset", device="cpu")
    toy = ["--data-root", str(data), "--train", "--epochs", "2", "--hidden", "8",
           "--emb-dim", "4", "--num-layers", "1", "--run-tag", "smoke", "--platform", "cpu",
           "--train-platform", "cpu"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    for cmd, out in (([sys.executable, str(SCRIPT)], "jax.json"),
                     ([sys.executable, "-m", "dvae_tpu_torch.cli.av_fusion_study"], "t.json")):
        r = subprocess.run([*cmd, *toy, "--models-root", str(tmp_path / out[:-5]),
                            "--out", str(tmp_path / out)], capture_output=True, text=True,
                           cwd=ROOT, env=env, timeout=1200)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())

    def keys(d):
        return {k: keys(v) for k, v in d.items()} if isinstance(d, dict) else None

    assert keys(got) == keys(want)
    for d in (got, want):
        del d["protocol"]["date"]
    assert got["protocol"] == want["protocol"] and got["checkpoints"] == want["checkpoints"]
    assert got["protocol"]["budgets"]["epochs"] == 2
    for modality in ("audio", "video", "av"):
        assert got["training"][modality]["epochs_trained"] == 1
        for cond in got["f1_per_condition"][modality].values():
            f1 = cond if isinstance(cond, float) else cond["f1"]
            assert 0.0 <= f1 <= 1.0
