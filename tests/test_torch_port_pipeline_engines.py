"""Port parity: the port's ``Enhancer`` against the JAX ``Enhancer`` for every
engine beside ``mcem`` and both oracle-latent ablations.

As in test_torch_port_pipeline.py: synthetic ragged wavs (and a second set
standing in for their clean parts), all-f32 configs, one NMF init shared by
both packages, and each engine in its deterministic config: PEEM and the
pinned latent as they are, peem-wf, pmcem and the clean-z MCEM with a
frozen chain (var_rw = 0). Float32-wire outputs agree to 1e-4 of the
signal peak. Unconditioned (M1's ``VAE``) and conditioned (``CVAE_v2``,
``dec_only``; ``CVAE``, ``enc_dec``, whose encoder also sees the labels
with the clean spectrogram) models.
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
from dvae_tpu_torch.enhance.mcem import McemConfig
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.models.convert import state_dict_from_jax
from test_torch_port_pipeline import BUDGET, shared_nmf_init, wavs  # noqa: F401  (fixture)
from test_torch_port_pipeline_cond import labels
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

KNOBS = dict(BUDGET, peem_steps=2, pmcem_chains=2, pmcem_steps=2, pmcem_wf_burn=1)
# (engine, ablation, family, y_mode)
CASES = {
    "peem": ("peem", "none", "VAE", "none"),
    "peem-wf": ("peem-wf", "none", "VAE", "none"),
    "pmcem": ("pmcem", "none", "VAE", "none"),
    "clean_z": ("mcem", "clean_z", "VAE", "none"),
    "clean_z_nomcem": ("peem", "clean_z_nomcem", "VAE", "none"),
    "pmcem-cvae_v2": ("pmcem", "none", "CVAE_v2", "dec_only"),
    "clean_z-cvae-enc_dec": ("peem-wf", "clean_z", "CVAE", "enc_dec"),
}


def _models(name, y_dim=1):
    init = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    if name == "VAE":
        jm = jmodels.VAE(x_dim=513, z_dim=16, h_dim=(32, 32))
        params = jm.init(init, jnp.ones((4, 513)))
        tm = tmodels.VAE(513, 16, (32, 32))
    else:
        jm = getattr(jmodels, name)(x_dim=513, y_dim=y_dim, z_dim=16, h_dim=(32, 32))
        params = jmodels.init_params(jm, init, jnp.ones((4, 513)), jnp.ones((4, y_dim)))
        tm = getattr(tmodels, name)(513, y_dim, 16, (32, 32))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("case", list(CASES))
def test_engine_and_ablation_enhancer_matches_jax(shared_nmf_init, case):
    engine, ablation, family, y_mode = CASES[case]
    jm, params, tm = _models(family)
    common = dict(wire_dtype="float32", y_mode=y_mode, engine=engine, ablation=ablation)
    jcfg = JaxEnhancerConfig(mcem=JaxMcemConfig(**KNOBS, fast_stats=False, fast_decoder=False),
                             **common)
    tcfg = EnhancerConfig(mcem=McemConfig(**KNOBS, fast_stats=False, fast_decoder=False),
                          **common)
    ws, cleans = wavs(), wavs(9)
    ys = None if y_mode == "none" else labels(ws, 1, "soft")
    jout = JaxEnhancer(jm, params, jcfg).enhance_batch(ws, ys, key=jax.random.PRNGKey(0),
                                                       clean_wavs=cleans)
    before = mh_chain.launches
    tout = Enhancer(tm, tcfg, device="cpu").enhance_batch(ws, ys, seed=0, clean_wavs=cleans)
    assert mh_chain.launches == before  # CPU tensors take the plain chain
    for (js, jn), (ts, tn), x in zip(jout, tout, ws):
        assert ts.shape == tn.shape == x.shape
        assert np.isfinite(ts).all() and np.isfinite(tn).all()
        peak = np.abs(js).max() + 1e-9
        np.testing.assert_allclose(ts, js, atol=1e-4 * peak)
        np.testing.assert_allclose(tn, jn, atol=1e-4 * peak)


def test_clean_wavs_route():
    """A clean-z ablation without clean waveforms raises ValueError; with
    them, enhance_batch and dispatch/collect agree (split at
    max_device_batch), and enhance_stream takes them as a fourth element;
    ablation "none" ignores clean waveforms; the clean latent changes the
    output."""
    _, _, tm = _models("VAE")
    quick = McemConfig(niter=2, nsamples_e_step=1, burnin_e_step=1, nsamples_wf=1, burnin_wf=1)
    ws, cleans = wavs(2, (5000, 6000, 7000)), wavs(3, (5000, 6000, 7000))
    enh = Enhancer(tm, EnhancerConfig(mcem=quick, ablation="clean_z_nomcem",
                                      max_device_batch=2), device="cpu")
    with pytest.raises(ValueError, match="clean waveforms"):
        enh.enhance_batch(ws)
    with pytest.raises(ValueError, match="clean waveforms"):
        list(enh.enhance_stream([(ws, None, None)]))
    got = enh.enhance_batch(ws, seed=3, clean_wavs=cleans)
    again = enh.collect(enh.dispatch(ws, seed=3, clean_wavs=cleans))
    stream = list(enh.enhance_stream([(ws, None, None, cleans), ([], None, None, [])], seed=3))
    assert [len(r) for r in stream] == [3, 0]
    for (a, _), (b, _) in zip(got, again):
        np.testing.assert_array_equal(a, b)

    plain = Enhancer(tm, EnhancerConfig(mcem=quick), device="cpu")
    base = plain.enhance_batch(ws, seed=3)
    for (a, _), (b, _) in zip(base, plain.enhance_batch(ws, seed=3, clean_wavs=cleans)):
        np.testing.assert_array_equal(a, b)
    assert any(np.abs(a - b).max() > 1e-4 * np.abs(b).max() for (a, _), (b, _) in zip(got, base))
