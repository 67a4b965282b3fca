"""Port parity: the reconstruction engine (``eval/reconstruct.py``), the
complex STFT it draws with and the figure library, against the JAX
package's on the CPU.

* ``stft`` / ``stft_to_host`` / ``power_spec``: both sides are f32 matmul
  DFTs that round low-power bins their own way, so spectra are held at
  rtol 1e-5 relative to each frame's peak (|S| or power).
* ``reconstruct`` for M1, M2 (``CVAE`` on VAD labels, ``CVAE_v2`` on IBM
  masks) and M2-info, the JAX weights carried across by
  ``models/convert.py``: the JAX sample's standard-normal noise is read
  back from its encoder (``(z - mu) * exp(-0.5 log_var)``, captured with
  flax's intermediates) and injected into the port, which then gives the
  JAX reconstruction at rtol 1e-4; ``sample=False`` too. The two packages
  draw their default samples from different generators, so a default call
  is only held to its own determinism.
* The three figure sets record the same file names and the same rows,
  bit for bit, as the JAX package's, ``_recon_aux``'s dataflow quirk
  included; one set is rendered for real, and the figure functions run.
* ``dvae_tpu_torch.eval`` and ``viz`` import without ``matplotlib`` and
  ``cv2``; a CLI that draws exits naming the missing package.
"""

import importlib
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.models as jmodels
from dvae_tpu import viz as jviz
from dvae_tpu.eval import reconstruct as jrec
from dvae_tpu.ops.stft import StftConfig as JaxStftConfig
from dvae_tpu.ops.stft import stft as jax_stft
from dvae_tpu.ops.stft import stft_to_host as jax_stft_to_host
from dvae_tpu_torch import viz
from dvae_tpu_torch.eval import reconstruct as rec
from dvae_tpu_torch.models import CVAE, VAE, CVAE_v2, DisentangledVAE
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.ops.stft import StftConfig, stft, stft_to_host
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

H = (32, 32)


def wav(seed=0, seconds=1.3):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    s = 0.3 * np.sin(2 * np.pi * (140 + 30 * rng.random()) * t) * (t % 0.5 < 0.3)
    return s + 0.01 * rng.standard_normal(n)


def frame_rel(got, want):
    """Largest |got - want| over each frame's peak |want|."""
    got, want = np.asarray(got), np.asarray(want)
    peak = np.abs(want).max(axis=-1, keepdims=True)
    return float((np.abs(got - want) / np.maximum(peak, 1e-30)).max())


@pytest.mark.parametrize("center", [False, True], ids=["plain", "centered"])
def test_stft_and_stft_to_host_match_jax(center):
    x = wav(1).astype(np.float32)
    tcfg, jcfg = StftConfig(center=center), JaxStftConfig(center=center)
    got = stft(torch.from_numpy(x), tcfg)
    want = np.asarray(jax_stft(jnp.asarray(x), jcfg))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert frame_rel(got.numpy(), want) < 1e-5
    host, jhost = stft_to_host(x, tcfg), jax_stft_to_host(x, jcfg)
    assert host.dtype == jhost.dtype == np.complex64 and host.shape == jhost.shape
    assert frame_rel(host, jhost) < 1e-5
    np.testing.assert_array_equal(host, got.numpy())
    np.testing.assert_array_equal(stft_to_host(torch.from_numpy(x), tcfg), host)


def test_power_spec_matches_jax():
    x = wav(2)
    S, x2 = rec.power_spec(x)
    jS, jx2 = jrec.power_spec(x)
    assert S.dtype == np.complex64 and x2.dtype == torch.float32 and x2.device.type == "cpu"
    assert S.shape == jS.shape == tuple(x2.shape) == jx2.shape
    assert frame_rel(S, jS) < 1e-5
    assert frame_rel(x2.numpy(), jx2) < 1e-5


def _captured_eps(model, params, x2, y):
    """The JAX forward's reconstruction with its default key, and the
    standard-normal noise its encoder drew there."""
    args = (jnp.asarray(x2),) if y is None else (jnp.asarray(x2), jnp.asarray(y))
    out, state = model.apply(params, *args, rngs={"sample": jax.random.PRNGKey(0)},
                             sample=True, capture_intermediates=True)

    def find(tree):
        for k, v in tree.items():
            if k == "sample" and "__call__" in v:
                return v["__call__"][0]
            if isinstance(v, dict) and (hit := find(v)) is not None:
                return hit
        return None

    z, mu, log_var = (np.asarray(a, np.float64) for a in find(state["intermediates"]))
    return np.asarray(out[0]), ((z - mu) * np.exp(-0.5 * log_var)).astype(np.float32)


FAMILIES = {
    "m1": (lambda: jmodels.VAE(x_dim=513, z_dim=16, h_dim=H), lambda: VAE(513, 16, H), None),
    "m2": (lambda: jmodels.CVAE(x_dim=513, y_dim=1, z_dim=16, h_dim=H),
           lambda: CVAE(513, 1, 16, H), 1),
    "m2v2_ibm": (lambda: jmodels.CVAE_v2(x_dim=513, y_dim=513, z_dim=16, h_dim=H),
                 lambda: CVAE_v2(513, 513, 16, H), 513),
    "m2_info": (lambda: jmodels.DisentangledVAE(x_dim=513, y_dim=1, z_dim=16, h_dim=H),
                lambda: DisentangledVAE(513, 1, 16, H), 1),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reconstruct_matches_jax_with_injected_eps(family):
    make_jax, make_port, y_dim = FAMILIES[family]
    jm = make_jax()
    init = [jnp.ones((4, 513))] + ([] if y_dim is None else [jnp.ones((4, y_dim))])
    params = jmodels.init_params(jm, {"params": jax.random.PRNGKey(3),
                                      "sample": jax.random.PRNGKey(4)}, *init)
    tm = make_port()
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    _, x2 = jrec.power_spec(wav(3))
    rng = np.random.default_rng(4)
    y = None if y_dim is None else (rng.random((len(x2), y_dim)) > 0.4).astype(np.float32)

    want = jrec.reconstruct(jm, params, x2, y)
    captured, eps = _captured_eps(jm, params, x2, y)
    np.testing.assert_array_equal(captured, want)
    got = rec.reconstruct(tm, x2, y, eps=eps)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(rec.reconstruct(tm, x2, y, sample=False),
                               jrec.reconstruct(jm, params, x2, y, sample=False), rtol=1e-4)
    # the port's default draw: its own generator, the same noise on every call
    a, b = rec.reconstruct(tm, x2, y), rec.reconstruct(tm, x2, y)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, rec.reconstruct(tm, x2, y, sample=False))
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(rec.reconstruct(tm, x2, y, generator=gen), a)
    if family == "m2_info":
        r, z = rec.reconstruct(tm, x2, y, eps=eps, return_z=True)
        jr, jz = jrec.reconstruct(jm, params, x2, y, return_z=True)
        np.testing.assert_allclose(r, jr, rtol=1e-4)
        np.testing.assert_allclose(z, jz, rtol=1e-4, atol=1e-5)
        for method, inp in (("classify_from_x", x2), ("classify_from_z", jz)):
            np.testing.assert_allclose(
                rec.classify(tm, method, inp),
                np.asarray(jm.apply(params, jnp.asarray(inp), method=method)),
                rtol=1e-4, atol=1e-6)


def test_helpers_match_jax(tmp_path):
    s = wav(5)
    np.testing.assert_array_equal(rec.oracle_vad(s), jrec.oracle_vad(s))
    r = np.random.default_rng(6).standard_normal((7, 513)).astype(np.float32)
    np.testing.assert_array_equal(rec.sqrt_recon(r), jrec.sqrt_recon(r))
    y = (r[:, :1] > 0).astype(np.float32)
    for (k1, v1), (k2, v2) in zip(rec.label_variants(y).items(),
                                  jrec.label_variants(y).items()):
        assert k1 == k2
        np.testing.assert_array_equal(v1, v2)
    proc = tmp_path / "processed"
    (proc / "ntcd_timit/Clean/test/spk1").mkdir(parents=True)
    (proc / "ntcd_timit/Noisy/LR/-5/test/spk1").mkdir(parents=True)
    for rel in ("ntcd_timit/Clean/test/spk1/sa1.wav", "ntcd_timit/Noisy/LR/-5/test/spk1/sa1.wav"):
        (proc / rel).write_bytes(b"")
    noisy = "ntcd_timit/Noisy/LR/-5/test/spk1/sa1.wav"
    for ext in (".h5", ".npz"):
        clean = f"ntcd_timit/Clean/test/spk1/sa1_vad_labels_upsampled{ext}"
        got = rec.ntcd_pair_wavs(str(proc), noisy, clean)
        assert got == (str(proc / "ntcd_timit/Clean/test/spk1/sa1.wav"), str(proc / noisy))
        assert got == jrec.ntcd_pair_wavs(str(proc), noisy, clean.replace(ext, ".h5"))
    assert rec.ntcd_pair_wavs(str(proc), noisy.replace("LR", "Babble"), clean) is None
    for a, b in ((viz.vad_as_mask(y[:, 0], 9), jviz.vad_as_mask(y[:, 0], 9)),
                 (viz._spec_db(r, False), jviz._spec_db(r, False)),
                 (viz._spec_db(r + 1j * r, False), jviz._spec_db(r + 1j * r, False))):
        np.testing.assert_array_equal(a, b)


def _recorded(monkeypatch, module, calls):
    def record(out_path, rows, cfg=None, vmin=-40.0, vmax=20.0):
        calls.append((str(out_path), list(rows), vmin, vmax))

    monkeypatch.setattr(module, "save_signal_rows", record)


def _same_rows(a, b):
    assert len(a) == len(b)
    for row_a, row_b in zip(a, b):
        assert len(row_a) == len(row_b) == 3
        for u, v in zip(row_a, row_b):
            assert (u is None) == (v is None)
            if u is not None:
                np.testing.assert_array_equal(u, v)


def test_figure_sets_record_the_jax_names_and_rows(monkeypatch, tmp_path):
    rng = np.random.default_rng(8)
    s_wav, x_wav = wav(9), wav(10)
    S, X = jax_stft_to_host(s_wav), jax_stft_to_host(x_wav)
    n = S.shape[0]
    r = [np.exp(rng.standard_normal((n, 513))).astype(np.float32) for _ in range(6)]
    y = (rng.random((n, 1)) > 0.5).astype(np.float32)
    soft, zsoft = rng.random((n, 1)).astype(np.float32), rng.random((n, 1)).astype(np.float32)
    sets = {
        "m1_figure_set": (s_wav, x_wav, S, X, r[0], r[1], y),
        "m2_figure_set": (s_wav, x_wav, S, X, r[0], r[1], r[2], r[3], y),
        "m2_info_figure_set": (s_wav, x_wav, S, X, *r, y, soft, zsoft),
    }
    names = {"m1_figure_set": ["_s_recon", "_x_recon"],
             "m2_figure_set": ["_s_recon", "_x_recon", "_x_recon_ones", "_x_recon_zeros"],
             "m2_info_figure_set": ["_s_recon", "_x_recon", "_x_recon_soft", "_x_recon_ones",
                                    "_x_recon_zeros", "_recon_aux"]}
    for name, args in sets.items():
        got, want = [], []
        _recorded(monkeypatch, rec, got)
        _recorded(monkeypatch, jrec, want)
        getattr(rec, name)(tmp_path / "Babble_-5_sa1", *args)
        getattr(jrec, name)(tmp_path / "Babble_-5_sa1", *args)
        assert [c[0] for c in got] == [c[0] for c in want] == [
            str(tmp_path / f"Babble_-5_sa1{s}.png") for s in names[name]]
        for (_, rows_t, *lim_t), (_, rows_j, *lim_j) in zip(got, want):
            assert lim_t == lim_j == [-40.0, 20.0]
            _same_rows(rows_t, rows_j)
        if name == "m2_info_figure_set":
            # _recon_aux: the clean-soft decode, then the NOISY-soft decode
            aux = got[-1][1]
            np.testing.assert_array_equal(aux[2][1], rec.sqrt_recon(r[3]))
            np.testing.assert_array_equal(aux[2][2], (zsoft > 0.5).astype(np.float32))


def test_figures_render(tmp_path):
    pytest.importorskip("matplotlib")
    s_wav, x_wav = wav(11, 0.6), wav(12, 0.6)
    S, s2 = rec.power_spec(s_wav)
    X, x2 = rec.power_spec(x_wav)
    y = rec.oracle_vad(s_wav)
    tm = VAE(513, 16, H)
    rec.m1_figure_set(tmp_path / "figs" / "utt", s_wav, x_wav, S, X,
                      rec.reconstruct(tm, s2), rec.reconstruct(tm, x2), y)
    pngs = sorted(p.name for p in (tmp_path / "figs").iterdir())
    assert pngs == ["utt_s_recon.png", "utt_x_recon.png"]
    assert all((tmp_path / "figs" / p).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" for p in pngs)
    plt = viz._plt()
    for fig in (viz.display_wav_spectro_mask(s_wav, np.abs(S), y),
                viz.display_multiple_spectro([S, np.abs(X) ** 2])):
        assert len(fig.axes) >= 2
        plt.close(fig)
    fig = plt.figure()
    viz.display_spectrogram(S, vad=y, ax=fig.gca())
    viz.display_power_spectro(np.abs(X) ** 2, ax=fig.gca())
    plt.close(fig)


def test_vad_demo_video(tmp_path):
    pytest.importorskip("cv2")
    frames = np.random.default_rng(13).uniform(0, 255, (12, 10, 30))
    vad = np.r_[np.zeros(10), np.ones(25)]
    out = viz.write_vad_demo_video(frames, vad, tmp_path / "demo.mp4")
    assert out == str(tmp_path / "demo.mp4") and (tmp_path / "demo.mp4").stat().st_size > 0
    with pytest.raises(ValueError, match="frames must be"):
        viz.write_vad_demo_video(frames[..., 0], vad, tmp_path / "bad.mp4")


_NO_PLOTS = """
import sys
sys.modules["matplotlib"] = None
sys.modules["cv2"] = None
import dvae_tpu_torch.eval, dvae_tpu_torch.eval.reconstruct, dvae_tpu_torch.viz
from dvae_tpu_torch.cli import reconstruct_m1, run_metrics, run_metrics_classif
assert not any(k.startswith(("matplotlib", "cv2")) for k in sys.modules if sys.modules[k])
print("ok")
"""


def test_eval_and_viz_import_without_matplotlib_or_cv2():
    proc = subprocess.run([sys.executable, "-c", _NO_PLOTS], capture_output=True, text=True,
                          timeout=120, cwd=str(pathlib.Path(__file__).parents[1]))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("cli,extra", [
    ("reconstruct_ntcd_m1", []), ("reconstruct_ntcd_m2", []), ("reconstruct_ntcd_m2_info", []),
    ("reconstruct_m1", []), ("reconstruct_m2", []), ("reconstruct_m2_info", []),
    ("run_metrics", ["--with-figures", "--model-output-dir", "out"]),
    ("run_metrics_classif", ["--with-figures", "--classifier-dir", "out"]),
    ("run_metrics_classif", ["--with-videos", "--classifier-dir", "out"]),
])
def test_drawing_clis_exit_naming_the_missing_package(monkeypatch, tmp_path, cli, extra):
    module = importlib.import_module(f"dvae_tpu_torch.cli.{cli}")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    # a checkpoint that does not exist: any model or device work would fail otherwise
    argv = ["--data-root", str(tmp_path), "--platform", "cpu", *extra]
    if cli.startswith("reconstruct"):
        argv += ["--checkpoint", str(tmp_path / "missing.pt")]
    with pytest.raises(SystemExit) as e:
        module.main(argv)
    assert ("opencv (cv2)" if "--with-videos" in extra else "need matplotlib") in str(e.value)
