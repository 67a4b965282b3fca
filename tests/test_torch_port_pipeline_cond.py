"""Port parity: the port's ``Enhancer`` against the JAX ``Enhancer`` on the
conditional families.

``enc_dec`` (``CVAE``, y_dim 1: the encoder sees ``[|X|^2; y]``) and
``dec_only`` (``CVAE_v2`` at y_dim 513, IBM-like binary labels;
``DisentangledVAE`` at y_dim 1, soft labels), on both wires. As in
test_torch_port_pipeline.py: synthetic ragged wavs, a frozen chain
(var_rw = 0), all-f32 MCEM configs and one NMF init shared by both
packages; float32-wire outputs agree to 1e-4 of the signal peak, PCM16
outputs to 2 LSB of the output grid (each utterance's wire scale, read
from the dispatch handles of both packages). The port folds ``y @ w1y`` into the
first layer's row bias where JAX multiplies ``[z, y]`` by ``[w1z; w1y]``:
the same f32 sum in another order, well inside those limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dvae_tpu.models as jmodels
import dvae_tpu_torch.models as tmodels
from dvae_tpu.enhance.mcem import McemConfig as JaxMcemConfig
from dvae_tpu.enhance.pipeline import Enhancer as JaxEnhancer
from dvae_tpu.enhance.pipeline import EnhancerConfig as JaxEnhancerConfig
from dvae_tpu_torch.enhance import mh_chain
from dvae_tpu_torch.enhance.mcem import McemConfig, fold_seed
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped
from test_torch_port_pipeline import BUDGET, shared_nmf_init, wavs  # noqa: F401  (fixture)
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

# (family, y_mode, y_dim, labels)
CASES = {"cvae-enc_dec": ("CVAE", "enc_dec", 1, "binary"),
         "cvae_v2-dec_only-ibm": ("CVAE_v2", "dec_only", 513, "binary"),
         "v5-dec_only": ("DisentangledVAE", "dec_only", 1, "soft")}


def _models(name, y_dim, h_dim=(32, 32)):
    jm = getattr(jmodels, name)(x_dim=513, y_dim=y_dim, z_dim=16, h_dim=h_dim)
    params = jmodels.init_params(jm, {"params": jax.random.PRNGKey(0),
                                      "sample": jax.random.PRNGKey(1)},
                                 jnp.ones((4, 513)), jnp.ones((4, y_dim)))
    tm = getattr(tmodels, name)(513, y_dim, 16, h_dim)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


def labels(ws, y_dim, kind, seed=0, extra=(3, -2, 0, 5)):
    """Per-utterance labels, some longer than the utterance's frames (the
    Enhancer cuts them) and one shorter (zero-padded)."""
    rng = np.random.default_rng(seed)
    out = []
    for w, e in zip(ws, extra):
        n = max(1, n_stft_frames_clamped(len(w), StftConfig()) + e)
        y = rng.uniform(size=(n, y_dim)).astype(np.float32)
        out.append((y > 0.5).astype(np.float32) if kind == "binary" else y)
    return out


@pytest.mark.parametrize("wire", ["float32", "int16"])
@pytest.mark.parametrize("case", list(CASES))
def test_conditioned_enhancer_matches_jax_frozen_chain(shared_nmf_init, case, wire):
    name, y_mode, y_dim, kind = CASES[case]
    jm, params, tm = _models(name, y_dim)
    jcfg = JaxEnhancerConfig(mcem=JaxMcemConfig(**BUDGET, fast_stats=False, fast_decoder=False),
                             wire_dtype=wire, y_mode=y_mode)
    tcfg = EnhancerConfig(mcem=McemConfig(**BUDGET, fast_stats=False, fast_decoder=False),
                          wire_dtype=wire,
                          y_mode=y_mode)
    ws = wavs()
    ys = labels(ws, y_dim, kind)
    jenh = JaxEnhancer(jm, params, jcfg)
    jh = jenh.dispatch(ws, ys, key=jax.random.PRNGKey(0))
    enh = Enhancer(tm, tcfg, device="cpu")
    before = mh_chain.launches
    th = enh.dispatch(ws, ys, seed=0)
    jout, tout = jenh.collect(jh), enh.collect(th)
    assert mh_chain.launches == before  # CPU tensors take the plain chain
    assert len(tout) == len(ws)
    # the PCM16 grid of each utterance, set by its padded row's peak (which
    # may lie past the utterance's end): the coarser of the two sides'
    # (the port's handle holds one output tuple per shard of the mesh)
    grid = np.maximum(np.asarray(jh[0][0][1]), th[0][0][0][1].numpy())
    for (js, jn), (ts, tn), x, q in zip(jout, tout, ws, grid):
        assert ts.shape == tn.shape == x.shape
        assert np.isfinite(ts).all() and np.isfinite(tn).all()
        tol = 1e-4 * (np.abs(js).max() + 1e-9) if wire == "float32" else 2 * q
        np.testing.assert_allclose(ts, js, atol=tol)
        np.testing.assert_allclose(tn, jn, atol=tol)
    assert np.isfinite(enh.last_cost).all()


def test_enc_dec_norm_matches_jax(shared_nmf_init):
    """std_norm statistics normalize the spectrogram only; y is
    concatenated after, and MCEM sees the raw power."""
    jm, params, tm = _models("CVAE", 1)
    rng = np.random.default_rng(5)
    norm = (rng.uniform(0.0, 2.0, (513, 1)).astype(np.float32),
            rng.uniform(0.5, 3.0, (513, 1)).astype(np.float32))
    jcfg = JaxEnhancerConfig(mcem=JaxMcemConfig(**BUDGET, fast_stats=False, fast_decoder=False),
                             wire_dtype="float32", y_mode="enc_dec", norm=norm)
    tcfg = EnhancerConfig(mcem=McemConfig(**BUDGET, fast_stats=False, fast_decoder=False),
                          wire_dtype="float32", y_mode="enc_dec", norm=norm)
    ws = wavs(4)
    ys = labels(ws, 1, "binary", seed=4)
    jout = JaxEnhancer(jm, params, jcfg).enhance_batch(ws, ys, key=jax.random.PRNGKey(0))
    tout = Enhancer(tm, tcfg, device="cpu").enhance_batch(ws, ys, seed=0)
    for (js, jn), (ts, tn) in zip(jout, tout):
        peak = np.abs(js).max() + 1e-9
        np.testing.assert_allclose(ts, js, atol=1e-4 * peak)
        np.testing.assert_allclose(tn, jn, atol=1e-4 * peak)


def test_labels_beyond_frames_are_inert_and_required():
    """Labels past an utterance's frames never reach the device: changing
    them changes nothing. A conditional y_mode without labels raises, as
    does a y_mode the model's decoder does not match."""
    _, _, tm = _models("CVAE_v2", 513)
    cfg = EnhancerConfig(mcem=McemConfig(**BUDGET), wire_dtype="float32", y_mode="dec_only")
    enh = Enhancer(tm, cfg, device="cpu")
    ws = wavs(6)
    ys = labels(ws, 513, "binary", seed=6, extra=(4, 4, 4, 4))
    noisy = [y.copy() for y in ys]
    for y in noisy:
        y[-4:] = 7.0
    a = enh.enhance_batch(ws, ys, seed=1)
    b = enh.enhance_batch(ws, noisy, seed=1)
    for (sa, na), (sb, nb) in zip(a, b):
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(na, nb)
    with pytest.raises(ValueError, match="y_mode=dec_only requires labels"):
        enh.enhance_batch(ws, seed=1)
    with pytest.raises(ValueError, match="y_mode=enc_dec requires labels"):
        Enhancer(_models("CVAE", 1)[2], EnhancerConfig(y_mode="enc_dec"),
                 device="cpu").enhance_batch(ws)
    with pytest.raises(ValueError, match="conditioning mismatch"):
        Enhancer(tm, EnhancerConfig(mcem=McemConfig(**BUDGET)), device="cpu").enhance_batch(ws)


def test_split_and_stream_slice_the_labels():
    """max_device_batch splits ys with the wavs (sub-batch j seeded
    fold_seed(seed, j)); enhance_stream takes ys per batch (batch i,
    sub-batch j seeded fold_seed(fold_seed(seed, i), j)); a fourth,
    clean-wavs element rides along unused when no clean-z ablation is
    set."""
    _, _, tm = _models("DisentangledVAE", 1)
    quick = McemConfig(niter=2, nsamples_e_step=1, burnin_e_step=1, nsamples_wf=1,
                       burnin_wf=1)
    enh = Enhancer(tm, EnhancerConfig(mcem=quick, max_device_batch=2, y_mode="dec_only"),
                   device="cpu")
    ws = wavs(7, (5000, 6000, 7000))
    ys = labels(ws, 1, "soft", seed=7)
    split = enh.enhance_batch(ws, ys, seed=3)
    assert [len(s) for s, _ in split] == [5000, 6000, 7000]
    parts = (enh.enhance_batch(ws[:2], ys[:2], seed=fold_seed(3, 0))
             + enh.enhance_batch(ws[2:], ys[2:], seed=fold_seed(3, 1)))
    for (a, _), (b, _) in zip(split, parts):
        np.testing.assert_array_equal(a, b)
    stream = list(enh.enhance_stream([(ws, ys, None), ([], None, None),
                                      (ws[:1], ys[:1], None)], seed=3))
    assert [len(r) for r in stream] == [3, 0, 1]
    first = enh.enhance_batch(ws[:1], ys[:1], seed=fold_seed(fold_seed(3, 2), 0))
    np.testing.assert_array_equal(stream[2][0][0], first[0][0])
    with_clean = list(enh.enhance_stream([(ws, ys, None, ws), ([], None, None, []),
                                          (ws[:1], ys[:1], None, ws[:1])], seed=3))
    for got, want in zip(with_clean, stream):
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("y_mode,wire", [("dec_only", "int16"), ("enc_dec", "float32")])
def test_conditioned_shape_fuzz(y_mode, wire):
    """Ragged lengths (one frame, bucket boundaries) at both y modes:
    finite, length-exact outputs, and the Wiener partition on the float32
    wire (the JAX package's test_enhancer_shape_fuzz)."""
    rng = np.random.default_rng(42)
    tm = (tmodels.CVAE if y_mode == "enc_dec" else tmodels.CVAE_v2)(513, 1, 4, (8, 8))
    tiny = McemConfig(niter=1, nsamples_e_step=1, burnin_e_step=1, nsamples_wf=1, burnin_wf=1)
    enh = Enhancer(tm, EnhancerConfig(mcem=tiny, y_mode=y_mode, wire_dtype=wire),
                   device="cpu")
    pool = [500, 1024, 4000, 16639, 16640, 16641, 24000]
    for batch in (1, 3):
        ls = [int(pool[rng.integers(len(pool))]) for _ in range(batch)]
        ws = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in ls]
        ys = [np.ones((n_stft_frames_clamped(n, StftConfig()), 1), np.float32) for n in ls]
        out = enh.enhance_batch(ws, ys, seed=batch)
        assert len(out) == batch
        for (s, n), w in zip(out, ws):
            assert len(s) == len(n) == len(w)
            assert np.isfinite(s).all() and np.isfinite(n).all()
            if wire == "float32" and len(w) >= 4000:
                np.testing.assert_allclose(s + n, w, atol=3e-4)
