"""Port parity: the port's ``Enhancer`` against the JAX ``Enhancer``.

Synthetic ragged wavs (harmonic + noise from a numpy seed), a frozen chain
(var_rw = 0) and all-f32 MCEM configs; both packages get the same NMF init
by monkeypatching each package's ``init_nmf`` inside the test. Wire float32
outputs agree to 1e-4 of the signal peak (float rounding through STFT,
MCEM and the masked ISTFT, amplified near utterance edges where the
window normalizer is small); PCM16 outputs to 2 LSB of the output grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.enhance.mcem as jmcem
import dvae_tpu_torch.enhance.mcem as tmcem
from dvae_tpu.enhance.mcem import McemConfig as JaxMcemConfig
from dvae_tpu.enhance.pipeline import Enhancer as JaxEnhancer
from dvae_tpu.enhance.pipeline import EnhancerConfig as JaxEnhancerConfig
from dvae_tpu.models import VAE as JaxVAE
from dvae_tpu_torch.enhance import mh_chain
from dvae_tpu_torch.enhance.mcem import McemConfig
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.models import VAE
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.parallel import make_mesh
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

BUDGET = dict(niter=3, nsamples_e_step=2, burnin_e_step=2, nsamples_wf=2, burnin_wf=2,
              var_rw=0.0)
LENGTHS = (16000, 11000, 600, 13500)  # ragged, one shorter than a frame


def wavs(seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        harm = sum(np.sin(2 * np.pi * (120 + 30 * i) * k * t) / k for k in range(1, 6))
        out.append((0.2 * harm + 0.05 * rng.standard_normal(n)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def models():
    jm = JaxVAE(x_dim=513, z_dim=16, h_dim=(32, 32))
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     jnp.ones((4, 513)))
    tm = VAE(513, 16, (32, 32))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


@pytest.fixture
def shared_nmf_init(monkeypatch):
    """Both packages' init_nmf return the same numpy-seeded (W, H, g)."""
    def draw(batch, n_frames, n_freq, rank, eps):
        rng = np.random.default_rng(batch * 1000 + n_frames)
        return (np.maximum(rng.uniform(size=(batch, n_freq, rank)), eps).astype(np.float32),
                np.maximum(rng.uniform(size=(batch, n_frames, rank)), eps).astype(np.float32),
                np.ones((batch, n_frames), np.float32))

    monkeypatch.setattr(jmcem, "init_nmf", lambda key, *a: tuple(map(jnp.asarray, draw(*a))))
    monkeypatch.setattr(tmcem, "init_nmf", lambda gen, *a, device=None: tuple(
        torch.from_numpy(m).to(device) for m in draw(*a)))


def _enhance_both(models, wire, **cfg_kw):
    jm, params, tm = models
    jcfg = JaxEnhancerConfig(mcem=JaxMcemConfig(**BUDGET, fast_stats=False, fast_decoder=False),
                             wire_dtype=wire, **cfg_kw)
    tcfg = EnhancerConfig(mcem=McemConfig(**BUDGET, fast_stats=False, fast_decoder=False),
                          wire_dtype=wire,
                          **cfg_kw)
    ws = wavs()
    jout = JaxEnhancer(jm, params, jcfg).enhance_batch(ws, key=jax.random.PRNGKey(0))
    enh = Enhancer(tm, tcfg, device="cpu")
    before = mh_chain.launches
    tout = enh.enhance_batch(ws, seed=0)
    assert mh_chain.launches == before  # CPU tensors take the plain chain
    return ws, jout, tout, enh


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_enhancer_matches_jax_frozen_chain(models, shared_nmf_init, wire):
    ws, jout, tout, enh = _enhance_both(models, wire)
    assert len(tout) == len(ws)
    for (js, jn), (ts, tn), x in zip(jout, tout, ws):
        assert ts.shape == tn.shape == x.shape
        assert np.isfinite(ts).all() and np.isfinite(tn).all()
        peak = np.abs(js).max() + 1e-9
        # PCM16: the output grid is peak/32767 per utterance
        tol = 1e-4 * peak if wire == "float32" else 2 * peak / 32767
        np.testing.assert_allclose(ts, js, atol=tol)
        np.testing.assert_allclose(tn, jn, atol=tol)
    assert enh.last_cost.shape == (BUDGET["niter"],) and np.isfinite(enh.last_cost).all()


def test_device_noise_matches_partition_and_lengths(models, shared_nmf_init):
    """noise_from_partition=False: the device ISTFT of WFn*X matches the
    host's X - S_hat on covered samples (the Wiener partition)."""
    _, _, tm = models
    cfg = EnhancerConfig(mcem=McemConfig(**BUDGET), wire_dtype="float32")
    ws = wavs(1)
    part = Enhancer(tm, cfg, device="cpu").enhance_batch(ws)
    dev = Enhancer(tm, EnhancerConfig(mcem=McemConfig(**BUDGET), wire_dtype="float32",
                                      noise_from_partition=False),
                   device="cpu").enhance_batch(ws)
    for (sp, np_), (sd, nd), x in zip(part, dev, ws):
        assert len(sp) == len(sd) == len(x)
        np.testing.assert_array_equal(sp[: len(x) - 1024], sd[: len(x) - 1024])
        core = slice(1024, max(1024, len(x) - 1024))
        np.testing.assert_allclose(np_[core], nd[core], atol=1e-4)
        np.testing.assert_allclose((sp + np_)[core], x[core], atol=1e-5)


def test_default_device_without_cuda_raises(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Enhancer(models[2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Enhancer(models[2], device="cuda")


@pytest.mark.parametrize("field,value", [("aot_dir", "/nonexistent")])
def test_unserved_config_values_raise(models, field, value):
    with pytest.raises(NotImplementedError, match="XLA-specific and is not ported"):
        Enhancer(models[2], EnhancerConfig(**{field: value}), device="cpu")
    # a mesh is served: two CPU shards (tests/test_torch_port_parallel.py)
    enh = Enhancer(models[2], EnhancerConfig(mcem=McemConfig(**BUDGET)), device="cpu",
                   mesh=make_mesh(2, device="cpu"))
    out = enh.enhance_batch(wavs()[:3], seed=0)
    assert [len(s) for s, _ in out] == list(LENGTHS[:3])
    assert all(np.isfinite(s).all() and np.isfinite(n).all() for s, n in out)


@pytest.mark.parametrize("field,value", [("engine", "gibbs"), ("ablation", "clean-z")])
def test_bad_engine_or_ablation_raises(models, field, value):
    with pytest.raises(ValueError, match=f"bad {field}"):
        Enhancer(models[2], EnhancerConfig(**{field: value}), device="cpu")


def test_enhancer_norm_matches_jax_frozen_chain(models, shared_nmf_init):
    """EnhancerConfig.norm (a std_norm model's train statistics) normalizes
    the encoder input only, as the JAX Enhancer does; same tolerance as the
    float32 wire above."""
    rng = np.random.default_rng(5)
    mean = rng.uniform(0.0, 2.0, (513, 1)).astype(np.float32)
    std = rng.uniform(0.5, 3.0, (513, 1)).astype(np.float32)
    ws, jout, tout, _ = _enhance_both(models, "float32", norm=(mean, std))
    _, _, plain, _ = _enhance_both(models, "float32")
    for (js, jn), (ts, tn), (ps, _) in zip(jout, tout, plain):
        peak = np.abs(js).max() + 1e-9
        np.testing.assert_allclose(ts, js, atol=1e-4 * peak)
        np.testing.assert_allclose(tn, jn, atol=1e-4 * peak)
    # the statistics change the encoder's z0 and so the masks
    assert any(np.abs(ts - ps).max() > 1e-3 * np.abs(ps).max() for (ts, _), (ps, _) in zip(tout, plain))


def test_split_stream_and_reload(models):
    """max_device_batch splits with per-sub-batch seeds; enhance_stream keeps
    one ordered result per batch (empty ones too); reload swaps weights."""
    _, _, tm = models
    quick = McemConfig(niter=2, nsamples_e_step=1, burnin_e_step=1, nsamples_wf=1,
                       burnin_wf=1)
    enh = Enhancer(tm, EnhancerConfig(mcem=quick, max_device_batch=2), device="cpu")
    ws = wavs(2, (5000, 6000, 7000))
    split = enh.enhance_batch(ws, seed=3)
    assert [len(s) for s, _ in split] == [5000, 6000, 7000]
    again = enh.collect(enh.dispatch(ws, seed=3))
    for (a, _), (b, _) in zip(split, again):
        np.testing.assert_array_equal(a, b)
    stream = list(enh.enhance_stream([(ws, None, None), ([], None, None),
                                      (ws[:1], None, None)], seed=3))
    assert [len(r) for r in stream] == [3, 0, 1]
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    enh.reload(sd)
    with pytest.raises(ValueError):
        enh.reload({k: v for k, v in list(sd.items())[1:]})
