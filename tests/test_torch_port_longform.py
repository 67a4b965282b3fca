"""Port parity: ``dvae_tpu_torch.enhance.longform`` against the JAX
package's ``dvae_tpu.enhance.longform``.

Spans and the cross-fade are pure numpy in both packages and must agree
bitwise over a grid of signal lengths, chunk lengths and overlaps (the
overlap above half a chunk raising in both). ``enhance_chunked`` through
one recording stand-in enhancer gives both packages the same chunk
waveforms, the same label slices (given labels and a labeler) and the same
outputs, bitwise. On real enhancers (frozen chain, var_rw = 0, f32
decoders, the same NMF init in both packages) the float32-wire outputs
agree to 1e-4 of the peak, the pipeline parity test's limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.enhance.longform as jlong
import dvae_tpu.enhance.mcem as jmcem
import dvae_tpu_torch.enhance.longform as tlong
import dvae_tpu_torch.enhance.mcem as tmcem
from dvae_tpu.enhance.mcem import McemConfig as JaxMcemConfig
from dvae_tpu.enhance.pipeline import Enhancer as JaxEnhancer
from dvae_tpu.enhance.pipeline import EnhancerConfig as JaxEnhancerConfig
from dvae_tpu.models import VAE as JaxVAE
from dvae_tpu_torch.enhance.mcem import McemConfig
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.models import VAE
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

CFG = StftConfig()
FS, HOP = CFG.fs, CFG.hop
BUDGET = dict(niter=2, nsamples_e_step=2, burnin_e_step=1, nsamples_wf=2, burnin_wf=1,
              var_rw=0.0)
LENGTHS = (1, 300, 16000, 16257, 52000, 123457)


def _noisy(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    return (0.4 * np.sin(2 * np.pi * 210 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("chunk,overlap", [(1.0, 0.25), (2.0, 0.0), (3.0, 1.5), (0.5, 0.2)])
def test_spans_and_overlap_add_bitwise(chunk, overlap):
    for n in LENGTHS:
        spans = tlong.chunk_spans(n, FS, HOP, chunk, overlap)
        assert spans == jlong.chunk_spans(n, FS, HOP, chunk, overlap)
        rng = np.random.default_rng(n)
        pieces = [rng.standard_normal(b - a).astype(np.float32) for a, b in spans]
        got = tlong.overlap_add(spans, pieces, n)
        np.testing.assert_array_equal(got, jlong.overlap_add(spans, pieces, n))
        assert got.dtype == np.float32 and got.shape == (n,)
        acc_t = tlong.StreamingOverlapAdd(spans, n)
        acc_j = jlong.StreamingOverlapAdd(spans, n)
        for p in pieces:
            np.testing.assert_array_equal(acc_t.add(p), acc_j.add(p))


def test_bad_overlap_and_misuse_raise_in_both():
    for mod in (tlong, jlong):
        with pytest.raises(ValueError, match="at most half the chunk"):
            mod.chunk_spans(50000, FS, HOP, 1.0, 0.6)
        with pytest.raises(ValueError, match="empty signal"):
            mod.chunk_spans(0, FS, HOP, 1.0, 0.25)
        spans = mod.chunk_spans(40000, FS, HOP, 1.0, 0.25)
        acc = mod.StreamingOverlapAdd(spans, 40000)
        with pytest.raises(ValueError, match="want"):
            acc.add(np.zeros(3))
        with pytest.raises(ValueError, match="pieces for"):
            mod.overlap_add(spans, [], 40000)


class _Recorder:
    """Stands in for either package's Enhancer: records every dispatch
    group and returns (0.5 w, 0.5 w + 0.01 * index) per chunk."""

    class cfg:  # noqa: N801 - mimics EnhancerConfig attribute access
        stft = CFG

    def __init__(self):
        self.groups = []

    def enhance_stream(self, batches, key=None, seed=None):
        for wavs, ys, _ in batches:
            self.groups.append(([np.array(w) for w in wavs],
                                None if ys is None else [np.array(y) for y in ys]))
            yield [(0.5 * w, 0.5 * w + 0.01 * i) for i, w in enumerate(wavs)]


@pytest.mark.parametrize("labels", ["none", "given", "labeler"])
def test_enhance_chunked_stand_in_matches_jax(labels):
    x = _noisy(int(5.3 * FS) + 77)
    n_frames = n_stft_frames_clamped(len(x), CFG)
    kw = dict(chunk_seconds=1.0, overlap_seconds=0.25, max_concurrent_chunks=3)
    if labels == "given":
        kw["y"] = np.arange(n_frames - 2, dtype=np.float32).reshape(-1, 1)  # short tail
    elif labels == "labeler":
        kw["labeler"] = lambda ws: [np.full((n_stft_frames_clamped(len(w), CFG), 1),
                                            float(len(w) + w[0]), np.float32) for w in ws]
    rt, rj = _Recorder(), _Recorder()
    st, nt = tlong.enhance_chunked(rt, x, seed=3, **kw)
    sj, nj = jlong.enhance_chunked(rj, x, key=None, **kw)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(st, 0.5 * x, atol=1e-6)
    n_spans = len(tlong.chunk_spans(len(x), FS, HOP, 1.0, 0.25))
    assert len(rt.groups) == len(rj.groups) == -(-n_spans // 3) >= 2
    for (wt, yt), (wj, yj) in zip(rt.groups, rj.groups):
        assert len(wt) == len(wj)
        for a, b in zip(wt, wj):
            np.testing.assert_array_equal(a, b)
        assert (yt is None) == (yj is None) == (labels == "none")
        for a, b in zip(yt or [], yj or []):
            np.testing.assert_array_equal(a, b)


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


def test_enhance_chunked_real_enhancer_matches_jax(shared_nmf_init):
    jm = JaxVAE(x_dim=513, z_dim=4, h_dim=(16, 16))
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     jnp.ones((4, 513)))
    tm = VAE(513, 4, (16, 16))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    jenh = JaxEnhancer(jm, params, JaxEnhancerConfig(
        mcem=JaxMcemConfig(**BUDGET, fast_stats=False, fast_decoder=False),
        wire_dtype="float32"))
    tenh = Enhancer(tm, EnhancerConfig(
        mcem=McemConfig(**BUDGET, fast_stats=False, fast_decoder=False),
        wire_dtype="float32"), device="cpu")
    x = _noisy(int(3.4 * FS), seed=5)
    kw = dict(chunk_seconds=1.0, overlap_seconds=0.25, max_concurrent_chunks=2)
    sj, nj = jlong.enhance_chunked(jenh, x, key=jax.random.PRNGKey(0), **kw)
    st, nt = tlong.enhance_chunked(tenh, x, seed=0, **kw)
    assert st.shape == nt.shape == x.shape
    peak = np.abs(sj).max()
    np.testing.assert_allclose(st, sj, atol=1e-4 * peak)
    np.testing.assert_allclose(nt, nj, atol=1e-4 * peak)
    core = slice(1024, len(x) - 1024)
    np.testing.assert_allclose((st + nt)[core], x[core], atol=1e-5)
