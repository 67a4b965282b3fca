"""The port's NTCD evaluation CLIs (``python -m
dvae_tpu_torch.cli.evaluate_ntcd_{m1,m2,m2_info_vad}``) on the CPU, and the
engine flags they share with ``enhance_wav``.

A synthetic processed tree (``_ntcd_tree.make_tree``) and ``.pt``
checkpoints of port models at h_dim (32, 32), a tiny budget. Checked: the
reference output layout, resume-by-skip, the golden prefix of the
clean-z-nomcem ablation, the label sources' suffixes (oracle h5s read with
``h5py``, classifier files, constants, self-soft labels, which equal the
JAX model's classifier on the clean utterance's spectrogram), shards that
cover the list once, the budget and engine flags, the warnings of the
PEEM-family guard, and the argument errors and the default to the card.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.models as jmodels
from dvae_tpu.ops.stft import StftConfig as JaxStftConfig
from dvae_tpu.ops.stft import stft as jax_stft
from dvae_tpu_torch.cli import _family, _sweep, enhance_wav
from dvae_tpu_torch.cli import evaluate_ntcd_m1 as m1_cli
from dvae_tpu_torch.cli import evaluate_ntcd_m2 as m2_cli
from dvae_tpu_torch.cli import evaluate_ntcd_m2_info_vad as info_cli
from dvae_tpu_torch.data.io import read_wav
from dvae_tpu_torch.models import CVAE, VAE, CVAE_v2, DisentangledVAE
from dvae_tpu_torch.models.convert import state_dict_from_jax
from _ntcd_tree import UTTS, make_tree
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

QUICK = ["--niter", "2", "--nsamples-e-step", "1", "--burnin-e-step", "1",
         "--nsamples-wf", "1", "--burnin-wf", "1", "--nmf-rank", "2", "--h-dim", "32", "32",
         "--pmcem-chains", "2", "--pmcem-steps", "2", "--peem-steps", "2"]
N_NOISY = 2 * len(UTTS)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ntcd")
    make_tree(root)
    torch.manual_seed(2)
    for name, model in (("m1", VAE(513, 16, (32, 32))), ("m2", CVAE(513, 1, 16, (32, 32))),
                        ("m2v2_ibm", CVAE_v2(513, 513, 16, (32, 32)))):
        torch.save(model.state_dict(), root / f"{name}.pt")
    jm = jmodels.DisentangledVAE(x_dim=513, y_dim=1, z_dim=16, h_dim=(32, 32))
    params = jmodels.init_params(jm, {"params": jax.random.PRNGKey(3),
                                      "sample": jax.random.PRNGKey(4)},
                                 jnp.ones((4, 513)), jnp.ones((4, 1)))
    v5 = DisentangledVAE(513, 1, 16, (32, 32))
    v5.load_state_dict(state_dict_from_jax(params), strict=True)
    torch.save(v5.state_dict(), root / "v5.pt")
    return root, (jm, params)


def argv(root, ckpt, out, *extra):
    return ["--data-root", str(root / "data"), "--checkpoint", str(root / ckpt),
            "--output-dir", str(out), "--snr", "all", "--platform", "cpu",
            "--batch-size", "4", *QUICK, *extra]


def outputs(out):
    return sorted(str(p.relative_to(out)) for p in out.rglob("*.wav"))


def test_m1_sweep_data_parallel_is_the_unsharded_sweep(tree, tmp_path):
    """``--data-parallel`` builds ``make_mesh()`` over the visible devices
    (one CPU shard here): the same enhanced files, bit for bit."""
    root, _ = tree
    a, b = tmp_path / "plain", tmp_path / "dp"
    assert m1_cli.main(argv(root, "m1.pt", a)) == N_NOISY
    assert m1_cli.main(argv(root, "m1.pt", b, "--data-parallel")) == N_NOISY
    assert outputs(a) == outputs(b)
    for name in outputs(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_m1_sweep_layout_resume_ablation_and_shards(tree, tmp_path, capsys):
    root, _ = tree
    out = tmp_path / "m1"
    assert m1_cli.main(argv(root, "m1.pt", out)) == N_NOISY
    names = outputs(out)
    want = sorted(f"ntcd_timit/Noisy/{noise}/-5/test/{spk}/{utt}_{k}_est.wav"
                  for noise in ("Babble", "LR") for spk, utt in UTTS for k in "ns")
    assert names == want
    for name in names:
        if name.endswith("_s_est.wav"):
            x, _ = read_wav(root / "data/subset/processed" / name.replace("_s_est", ""))
            s, fs = read_wav(out / name)
            n, _ = read_wav(out / name.replace("_s_est", "_n_est"))
            assert fs == 16000 and len(s) == len(n) == len(x) and np.isfinite(s).all()
    stamps = {p: p.stat().st_mtime_ns for p in out.rglob("*.wav")}
    assert m1_cli.main(argv(root, "m1.pt", out)) == 0
    assert stamps == {p: p.stat().st_mtime_ns for p in out.rglob("*.wav")}
    assert "done: 0 utterances" in capsys.readouterr().out

    assert m1_cli.main(argv(root, "m1.pt", out, "--ablation", "clean-z-nomcem")) == N_NOISY
    golden = [n for n in outputs(out) if "_clean_z_nomcem_" in n]
    assert sorted(golden) == sorted(n.replace("_s_est", "_clean_z_nomcem_s_est")
                                    .replace("_n_est", "_clean_z_nomcem_n_est") for n in want)

    parts = [outputs(tmp_path / f"s{k}") for k in range(2)
             if m1_cli.main(argv(root, "m1.pt", tmp_path / f"s{k}", "--shard", f"{k}/2",
                                 "--engine", "pmcem")) > 0]
    assert len(parts) == 2 and not set(parts[0]) & set(parts[1])
    assert sorted(parts[0] + parts[1]) == want


def test_m1_reference_budgets_and_engine_flags(tree, monkeypatch):
    root, _ = tree
    seen = {}

    def fake_sweep(args, enh, out_dir, y_loader=None, suffix=""):
        seen.update(cfg=enh.cfg, out=out_dir)
        return 0

    monkeypatch.setattr(m1_cli, "run_sweep", fake_sweep)
    base = ["--data-root", str(root / "data"), "--checkpoint", str(root / "m1.pt"),
            "--models-root", str(root / "models"), "--platform", "cpu", "--h-dim", "32", "32"]
    m1_cli.main(base + ["--m1-reference-budgets", "--burnin-wf", "7"])
    mc = seen["cfg"].mcem
    assert (mc.nsamples_e_step, mc.burnin_e_step, mc.nsamples_wf, mc.burnin_wf) == (30, 30, 75, 7)
    assert seen["out"] == str(root / "models" / "enhanced" / root.name / "m1")
    m1_cli.main(base + ["--engine", "pmcem", "--pmcem-chains", "5", "--pmcem-steps", "3",
                        "--ablation", "clean-z"])
    assert seen["cfg"].engine == "pmcem" and seen["cfg"].ablation == "clean_z"
    assert (seen["cfg"].mcem.pmcem_chains, seen["cfg"].mcem.pmcem_steps) == (5, 3)
    with pytest.warns(UserWarning, match="--niter 20 < 100"):
        m1_cli.main(base + ["--engine", "peem", "--niter", "20", "--peem-lr", "0.05",
                            "--peem-steps", "6"])
    assert (seen["cfg"].mcem.peem_lr, seen["cfg"].mcem.peem_steps) == (0.05, 6)


@pytest.mark.parametrize("source,suffix", [("oracle", ""), ("ones", "_oracle_1"),
                                           ("classifier", "_y_hat_hard")])
def test_m2_label_sources(tree, tmp_path, source, suffix):
    root, _ = tree
    extra = ["--y-source", source, "--engine", "peem-wf"]
    if source == "classifier":
        for spk, utt in UTTS:
            d = tmp_path / "clf" / spk
            d.mkdir(parents=True, exist_ok=True)
            torch.save(torch.ones(400), d / f"{utt}_y_hat_hard.pt")
        extra += ["--classifier-dir", str(tmp_path / "clf")]
    out = tmp_path / "out"
    with pytest.warns(UserWarning, match="--niter 2 < 100") as said:
        assert m2_cli.main(argv(root, "m2.pt", out, *extra)) == N_NOISY
    assert len(said) == 1  # VAD-conditioned M2: no engine-family warning
    names = outputs(out)
    assert len(names) == 2 * N_NOISY
    assert all(n.endswith((f"_s_est{suffix}.wav", f"_n_est{suffix}.wav")) for n in names)


def test_m2_ibm_warns_for_pmcem(tree, tmp_path):
    root, _ = tree
    with pytest.warns(UserWarning, match="IBM-conditioned"):
        n = m2_cli.main(argv(root, "m2v2_ibm.pt", tmp_path / "o", "--labels", "ibm_labels",
                             "--model-variant", "v2", "--engine", "pmcem", "--shard", "0/5"))
    assert n == 2


def test_m2_info_self_soft_pmcem_and_saved_labels(tree, tmp_path):
    """Self-soft labels through the STFT power path: each utterance's saved
    labels equal the JAX model's classifier on the JAX STFT power of its
    clean wav (1e-5 absolute)."""
    root, (jm, params) = tree
    out = tmp_path / "out"
    n = info_cli.main(argv(root, "v5.pt", out, "--y-source", "self-soft", "--engine", "pmcem",
                           "--save-labels"))
    assert n == N_NOISY
    names = outputs(out)
    assert len(names) == 2 * N_NOISY and all("_est_y_hat_soft.wav" in n for n in names)
    saved = sorted(out.rglob("*_y_hat_soft.npy"))
    assert len(saved) == N_NOISY
    proc = root / "data/subset/processed/ntcd_timit"
    for path in saved[:3]:
        spk, utt = path.parent.name, path.name.split("_y_hat_soft")[0]
        s, _ = read_wav(proc / "Clean/test" / spk / f"{utt}.wav")
        s2 = jnp.abs(jax_stft(jnp.asarray(s, jnp.float32), JaxStftConfig())) ** 2
        want = np.asarray(jm.apply(params, s2, method="classify_from_x")).reshape(-1, 1)
        np.testing.assert_allclose(np.load(path), want, atol=1e-5)
    # a second run saves nothing new and enhances nothing
    assert info_cli.main(argv(root, "v5.pt", out, "--y-source", "self-soft", "--engine",
                              "pmcem", "--save-labels")) == 0


def test_m2_info_oracle_labels_suffix(tree, tmp_path):
    root, _ = tree
    out = tmp_path / "out"
    assert info_cli.main(argv(root, "v5.pt", out, "--shard", "1/4")) > 0
    assert all("_est_oracle_y.wav" in n for n in outputs(out))


@pytest.mark.parametrize("cli,extra,message", [
    # the parser takes --data-parallel (the sweep under it:
    # test_m1_sweep_data_parallel_is_the_unsharded_sweep)
    (m1_cli, ["--data-parallel", "--platform", "tpu"], "invalid choice: 'tpu'"),
    (m1_cli, ["--engine", "gibbs"], "invalid choice: 'gibbs'"),
    (m1_cli, ["--ablation", "clean_z"], "invalid choice: 'clean_z'"),
    (m2_cli, ["--y-source", "classifier"], "requires --classifier-dir"),
    (info_cli, ["--labels", "ibm_labels"], "VAD-conditioned"),
    (info_cli, ["--y-source", "classifier"], "requires --classifier-dir"),
])
def test_argument_errors(tmp_path, capsys, cli, extra, message):
    with pytest.raises(SystemExit) as e:
        cli.main(["--checkpoint", str(tmp_path / "x.pt"), "--platform", "cpu", *extra])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("cli", [m1_cli, m2_cli, info_cli])
def test_checkpoint_shard_and_card_errors(tree, tmp_path, capsys, cli):
    root, _ = tree
    with pytest.raises(SystemExit) as e:
        cli.main(["--platform", "cpu"])
    assert e.value.code == 2 and "need --checkpoint or --model-dir" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="0 <= K < N"):
        cli.main(["--checkpoint", "x.pt", "--shard", "2/2", "--platform", "cpu"])
    with pytest.raises(SystemExit, match="export_torch_checkpoint"):
        cli.main(["--checkpoint", str(tmp_path / "m.msgpack"), "--platform", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--data-root", str(root / "data"), "--checkpoint", str(root / "m1.pt")])


def test_std_norm_reads_the_frame_h5(tree, tmp_path):
    import h5py

    root, _ = tree
    args = _sweep.parse_sweep_args(_sweep.sweep_parser("p", ""), [
        "--data-root", str(tmp_path), "--checkpoint", "x.pt", "--std-norm"])
    h5 = tmp_path / "subset/processed/ntcd_timit/Clean_vad_labels_upsampled.h5"
    h5.parent.mkdir(parents=True)
    with h5py.File(h5, "w") as f:
        f["X_train_mean"] = np.full((513, 1), 2.0)
        f["X_train_std"] = np.full((513, 1), 3.0)
    mean, std = _family.norm_stats_if(args)
    assert mean.shape == std.shape == (513, 1) and mean[0, 0] == 2.0 and std[0, 0] == 3.0
    other = tmp_path / "other.h5"
    h5.rename(other)
    args.norm_h5 = str(other)
    assert _family.norm_stats_if(args)[1][0, 0] == 3.0
    args.std_norm = False
    assert _family.norm_stats_if(args) is None


def test_warn_peem_family_guard():
    def args(engine):
        return type("A", (), {"engine": engine})()

    for engine in ("peem", "peem-wf", "pmcem"):
        for cls, y_dim in (("v3", 1), ("m2", 513), ("m2v2", 513)):
            with pytest.warns(UserWarning, match="paired MCEM check"):
                _family.warn_peem_family(args(engine), cls, y_dim)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for engine, cls, y_dim in (("mcem", "v3", 1), ("peem", "m2", 1), ("pmcem", "v5", 1),
                                   ("peem", "m1", 1)):
            _family.warn_peem_family(args(engine), cls, y_dim)


def test_enhance_wav_serves_the_engines(tree, tmp_path):
    root, _ = tree
    noisy = root / "data/subset/processed/ntcd_timit/Noisy/LR/-5/test/spk02"
    for engine in ("peem", "pmcem"):
        out = tmp_path / engine
        enhance_wav.main([str(noisy), "--checkpoint", str(root / "m1.pt"), "--output-dir",
                          str(out), "--platform", "cpu", "--engine", engine, *QUICK])
        assert sorted(p.name for p in out.iterdir()) == ["sa1_n_est.wav", "sa1_s_est.wav",
                                                         "si3_n_est.wav", "si3_s_est.wav"]
    with pytest.warns(UserWarning, match="IBM-conditioned"):
        enhance_wav.main([str(noisy), "--checkpoint", str(root / "m2v2_ibm.pt"),
                          "--model-class", "m2v2", "--y-dim", "513", "--y-source", "ones",
                          "--output-dir", str(tmp_path / "ibm"), "--platform", "cpu",
                          "--engine", "peem", *QUICK])
