"""Port parity at ``McemConfig.fast_stats=True``, the default of both packages.

The JAX scan engine keeps the chain's planes in bf16: its energy reads
|X|^2 and Vb rounded to bf16, the E-step emits bf16 Vs samples, the M-step
rounds its R-sums to the samples' dtype, and the cost is taken on the bf16
samples; the Wiener sums keep the f32 Vb. The port does the same, and here
each piece is held against JAX's, fed the same numpy-seeded inputs (F 65,
L 8, two hidden layers of 32, B 2, N 16 with a padded tail):

* the energy on the rounded planes against ``_make_mh_step(...,
  stats_dtype=bf16)``'s, to f32 rounding (rtol 1e-6);
* a live chain (var_rw 0.01), E-step and WF, against JAX's ``step_light`` /
  ``step`` driven in a loop, the port's plain chain fed the noise those
  steps draw from the same keys: bf16 samples that differ from JAX's in at
  most 1e-3 of the elements and by at most one bf16 ulp (2^-7 relative; a
  one-ulp flip is where the two f32 decoders round an element to either
  side of a bf16 boundary: none at these inputs), WF sums to rtol 1e-5;
* the M-step on the same bf16 samples: one step to rtol 1e-5; five chained
  steps to rtol 1e-3, since an R-sum within f32 rounding of a bf16
  boundary rounds to either side in the two packages (one bf16 ulp, ~0.4%)
  and moves W by up to ~3e-4 after five steps;
* run_mcem, run_pmcem and run_peem_wf with a frozen chain (var_rw 0) and a
  shared NMF init against the JAX scan engines, every output at rtol 1e-3
  (atol 1e-6, 1e-5 for the latent), at fast_decoder False and True: the
  f32 runs agree to 1e-4 (``test_torch_port_engines.py``), but an emitted
  sample or an R-sum within f32 rounding of a bf16 boundary rounds to
  either side in the two packages, and such one-ulp flips move W by up to
  ~5e-4 after five EM iterations, where the flag itself moves it by ~5e-3;
  the port's ``Enhancer`` at the default config (frozen, with
  a small budget) against the JAX ``Enhancer`` at its default, waveforms
  within 5e-4 of each utterance's peak (the bf16 decoder's rows, amplified
  where the ISTFT's window normalizer is small).

Each engine and ``Enhancer`` comparison also shows that the flag acts: the
port's run differs from JAX's ``fast_stats=False`` run by more than the
tolerance it meets against JAX's ``fast_stats=True`` run. A frozen chain
always accepts, so peem-wf (whose EM loop ignores the flag) shows it only
through a live Wiener chain (var_rw 0.1, 10 + 20 steps, where the rounded
energy flips an acceptance): the port's ``make_chain_noise`` is swapped for
the noise JAX's Wiener tail draws from its key.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.enhance.mcem as jmcem
import dvae_tpu.models as jmodels
import dvae_tpu_torch.enhance.mcem as tmcem
import dvae_tpu_torch.models as tmodels
from dvae_tpu.enhance import nmf as jnmf
from dvae_tpu.enhance.pallas_mcem import extract_decoder_mlp as jax_extract
from dvae_tpu.enhance.pipeline import Enhancer as JaxEnhancer
from dvae_tpu.enhance.pipeline import EnhancerConfig as JaxEnhancerConfig
from dvae_tpu_torch.enhance import mh_chain
from dvae_tpu_torch.enhance import nmf as tnmf
from dvae_tpu_torch.enhance.mh_chain import (
    chain_energy,
    energy_planes,
    extract_decoder_mlp,
    mh_chain_reference,
    run_mh_chain,
)
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.models.convert import state_dict_from_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_pipeline import shared_nmf_init, wavs  # noqa: F401  (fixture)

B, N, F, L, K, R = 2, 16, 65, 8, 4, 3
ROWS = B * N
BUDGET = dict(nsamples_e_step=3, burnin_e_step=2, nsamples_wf=4, burnin_wf=2, nmf_rank=K,
              peem_steps=3, pmcem_chains=3, pmcem_steps=2, pmcem_wf_burn=2)
NAMES = ("wfs", "wfn", "cost", "z", "w", "h", "g")
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative, at most


@functools.cache
def _problem():
    jm = jmodels.VAE(x_dim=F, z_dim=L, h_dim=(32, 32))
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     jnp.ones((4, F)))
    tm = tmodels.VAE(F, L, (32, 32))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    rng = np.random.default_rng(0)
    z_true = rng.standard_normal((B, N, L)).astype(np.float32)
    vs = np.asarray(jm.apply(params, jnp.asarray(z_true), method="decode"))
    vb = (0.5 + 0.1 * rng.uniform(size=(B, N, F))).astype(np.float32)
    x2 = ((vs + vb) * rng.standard_normal((B, N, F)) ** 2 + 1e-3).astype(np.float32)
    z0 = (0.5 * rng.standard_normal((B, N, L))).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 11:] = 0.0
    w = np.maximum(rng.uniform(size=(B, F, K)), 1e-8).astype(np.float32)
    h = np.maximum(rng.uniform(size=(B, N, K)), 1e-8).astype(np.float32)
    g = rng.uniform(0.5, 1.5, size=(B, N)).astype(np.float32)
    return dict(jm=jm, params=params, tm=tm, x2=x2, vb=vb, z0=z0, mask=mask, g=g,
                nmf=(w, h, np.ones((B, N), np.float32)))


@pytest.fixture
def p():
    return _problem()


def _jdec(p):
    return lambda zin: p["jm"].apply(p["params"], zin, method="decode")


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _step_noise(keys, shape):
    """The (steps, rows, L + 1) noise JAX's ``step`` / ``step_light`` draw
    from ``keys`` for latents of ``shape`` (B, N, L)."""
    out = []
    for key in keys:
        k1, k2 = jax.random.split(key)
        eps = np.asarray(jax.random.normal(k1, shape)).reshape(-1, shape[-1])
        log_u = np.asarray(jnp.log(jax.random.uniform(k2, shape[:-1], minval=1e-38)))
        out.append(np.concatenate([eps, log_u.reshape(-1, 1)], -1))
    return torch.from_numpy(np.stack(out))


def _worst(got, want, rtol, atol):
    """The largest |got - want| over ``atol + rtol |want|``: <= 1 passes."""
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def test_energy_on_rounded_planes_matches_jax(p):
    """The energy the port's chain takes under fast_stats (x2 and Vb rounded
    to bf16, f32 arithmetic) is JAX's ``stats_dtype=bf16`` energy."""
    rng = np.random.default_rng(1)
    z = rng.standard_normal((B, N, L)).astype(np.float32)
    vs = np.asarray(_jdec(p)(jnp.asarray(z)))
    _, energy, _, _ = jmcem._make_mh_step(_jdec(p), jnp.asarray(p["x2"]), None, 0.01,
                                          stats_dtype=jnp.bfloat16)
    want = np.asarray(energy(jnp.asarray(z), jnp.asarray(vs),
                             jnp.asarray(p["vb"]).astype(jnp.bfloat16), jnp.asarray(p["g"])))
    x2_plane = _bf16(p["x2"].reshape(ROWS, F))
    got = {}
    for wf_mode, vb_plane in ((False, _bf16(p["vb"].reshape(ROWS, F))),
                              (True, torch.from_numpy(p["vb"].reshape(ROWS, F)))):
        got[wf_mode] = chain_energy(torch.from_numpy(z.reshape(ROWS, L)),
                                    torch.from_numpy(vs.reshape(ROWS, F)),
                                    *energy_planes(x2_plane, vb_plane, True),
                                    torch.from_numpy(p["g"].reshape(ROWS))).numpy()
        np.testing.assert_allclose(got[wf_mode], want.reshape(ROWS), rtol=1e-6)
    f32 = chain_energy(torch.from_numpy(z.reshape(ROWS, L)), torch.from_numpy(vs.reshape(ROWS, F)),
                       torch.from_numpy(p["x2"].reshape(ROWS, F)),
                       torch.from_numpy(p["vb"].reshape(ROWS, F)),
                       torch.from_numpy(p["g"].reshape(ROWS))).numpy()
    assert _worst(f32, want.reshape(ROWS), 1e-6, 0.0) > 1.0  # the rounding acts


@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_live_chain_matches_jax_scan_steps(p, wf_mode):
    """JAX's scan steps at stats_dtype=bf16 in a loop (burn-in on the light
    carry, then the full step, emitting ``vs.astype(bf16)`` or summing the
    Wiener masks over the f32 Vb) against the port's plain chain at
    fast_stats=True fed the same noise."""
    var_rw, n_burn, n_samp = 0.01, 4, 6
    dec, energy, step, step_light = jmcem._make_mh_step(
        _jdec(p), jnp.asarray(p["x2"]), None, var_rw, stats_dtype=jnp.bfloat16)
    vb, g = jnp.asarray(p["vb"]), jnp.asarray(p["g"])
    vbe = vb.astype(jnp.bfloat16)
    z = jnp.asarray(p["z0"])
    e = energy(z, dec(z), vbe, g)
    keys = jax.random.split(jax.random.PRNGKey(7), n_burn + n_samp)
    for key in keys[:n_burn]:
        (z, e), _ = step_light((z, e), key, vbe, g)
    vs = dec(z)
    samples, wfs, wfn = [], 0.0, 0.0
    for key in keys[n_burn:]:
        (z, vs, e), _ = step((z, vs, e), key, vbe, g)
        samples.append(vs.astype(jnp.bfloat16))
        vsc = g[:, :, None] * vs
        vx = jnp.maximum(vsc + vb, tnmf.VX_FLOOR)
        wfs, wfn = wfs + vsc / vx, wfn + vb / vx

    vb_plane = torch.from_numpy(p["vb"].reshape(ROWS, F))
    out = mh_chain_reference(
        extract_decoder_mlp(p["tm"], L), _bf16(p["x2"].reshape(ROWS, F)),
        vb_plane if wf_mode else vb_plane.to(torch.bfloat16),
        torch.from_numpy(p["g"].reshape(ROWS)), torch.from_numpy(p["z0"].reshape(ROWS, L)),
        None, _step_noise(keys, z.shape), n_burn, n_samp, var_rw, wf_mode, fast_stats=True)
    zj = np.asarray(z).reshape(ROWS, L)
    np.testing.assert_allclose(out[0].numpy(), zj, atol=1e-5)
    assert (zj != p["z0"].reshape(ROWS, L)).any(-1).mean() > 0.5  # the chain moved
    if wf_mode:
        for got, want in zip(out[1:], (wfs, wfn)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(ROWS, F), rtol=1e-5)
        np.testing.assert_allclose((out[1] + out[2]).numpy(), n_samp, rtol=1e-6)
        return
    got = out[1]
    assert got.dtype == torch.bfloat16 and got.shape == (n_samp, ROWS, F)
    got = got.float().numpy()
    want = np.asarray(jnp.stack(samples).astype(jnp.float32)).reshape(n_samp, ROWS, F)
    assert (got != want).mean() <= 1e-3
    assert np.max(np.abs(got - want) / np.abs(want)) <= BF16_ULP


def test_m_step_on_bf16_samples_matches_jax(p):
    """nmf_m_step on bf16 Vs against the JAX one on the same bf16 Vs; the
    R-sums' rounding to bf16 moves the result against the f32 upcast of
    the same samples by far more than the tolerance."""
    rng = np.random.default_rng(2)
    vs = (rng.uniform(size=(R, B, N, F)) + 0.05).astype(np.float32)
    vs_t, vs_j = _bf16(vs), jnp.asarray(vs).astype(jnp.bfloat16)
    w, h, _ = p["nmf"]
    args_t = tuple(map(torch.from_numpy, (p["x2"], w, h, p["g"], p["mask"])))
    args_j = tuple(map(jnp.asarray, (p["x2"], w, h, p["g"], p["mask"])))
    for steps, rtol in ((1, 1e-5), (5, 1e-3)):
        (x2t, tw, th, tg, mt), (x2j, jw, jh, jg, mj) = args_t, args_j
        for _ in range(steps):
            tw, th, tg, tvb = tnmf.nmf_m_step(x2t, vs_t, tw, th, tg, mt)
            jw, jh, jg, jvb = jnmf.nmf_m_step(x2j, vs_j, jw, jh, jg, mj)
        for name, a, b in zip("whgv", (jw, jh, jg, jvb), (tw, th, tg, tvb)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol, atol=1e-7,
                                       err_msg=f"{name}@{steps}")
    x2t, tw, th, tg, mt = args_t
    one = tnmf.nmf_m_step(x2t, vs_t, tw, th, tg, mt)[0].numpy()
    up = tnmf.nmf_m_step(x2t, vs_t.float(), tw, th, tg, mt)[0].numpy()
    assert _worst(one, up, 1e-5, 1e-7) > 1.0


def run_jax(p, engine, kw, fast_stats, fast=False):
    cfg = jmcem.McemConfig(**kw, fast_stats=fast_stats, fast_decoder=fast)
    args = (_jdec(p), jnp.asarray(p["x2"]), jnp.asarray(p["z0"]), jnp.asarray(p["mask"]))
    jkw = dict(nmf_init=tuple(map(jnp.asarray, p["nmf"])),
               decoder_mats=jax_extract(p["params"], L))
    key = jax.random.PRNGKey(3)
    if engine == "run_peem_wf":
        res = jmcem.run_peem_wf(*args, cfg, key=key, **jkw)
    else:
        res = getattr(jmcem, engine)(*args, key, cfg, **jkw)
    return [np.asarray(a) for a in res]


def run_port(p, engine, kw, fast=False):
    res = getattr(tmcem, engine)(
        extract_decoder_mlp(p["tm"], L), torch.from_numpy(p["x2"]), torch.from_numpy(p["z0"]),
        torch.from_numpy(p["mask"]), 3, tmcem.McemConfig(**kw, fast_decoder=fast), None,
        tuple(map(torch.from_numpy, p["nmf"])))
    assert res.wfs.dtype == torch.float32
    return [a.detach().numpy() for a in res]


def _against_both(p, engine, kw, rtol, fast=False, prove=True):
    """The port at the default fast_stats=True against JAX at True (every
    output within ``rtol``) and at False (some output beyond it, when
    ``prove``); the Wiener partition and the padded tail."""
    pr = run_port(p, engine, kw, fast)
    worst = {}
    for stats in (True, False):
        jr = run_jax(p, engine, kw, stats, fast)
        worst[stats] = max(_worst(b, a, rtol, 1e-5 if name == "z" else 1e-6)
                           for name, a, b in zip(NAMES, jr, pr))
    assert worst[True] <= 1.0
    if prove:
        assert worst[False] > 1.0
    mask = p["mask"]
    assert np.abs(pr[0][1, 11:]).max() == 0.0 and np.abs(pr[1][1, 11:]).max() == 0.0
    np.testing.assert_allclose((pr[0] + pr[1])[mask > 0], 1.0, atol=1e-5)
    return worst


@pytest.mark.parametrize("engine,fast", [
    ("run_mcem", False), ("run_pmcem", False), ("run_peem_wf", False), ("run_mcem", True)],
    ids=["mcem", "pmcem", "peem_wf", "mcem-bf16-decoder"])
def test_frozen_engines_match_jax_fast_stats(p, engine, fast):
    """Frozen chain, shared NMF init, fast_stats=True on both sides. A frozen
    chain accepts every step, so peem-wf's outputs do not depend on the
    flag: its proof is the live test below."""
    before = mh_chain.launches
    _against_both(p, engine, dict(niter=5, var_rw=0.0, **BUDGET), 1e-3, fast,
                  prove=engine != "run_peem_wf")
    assert mh_chain.launches == before  # CPU tensors take the plain chain


def test_live_peem_wf_matches_jax_fast_stats(p, monkeypatch):
    """peem-wf with a live Wiener chain, the port fed the noise JAX's
    Wiener tail draws (``split(key, 3)[2]``, then burn-in and collect keys
    as ``_wf_expectation`` splits them): the flag changes which proposals
    the chain accepts."""
    kw = dict(niter=3, var_rw=0.1, **dict(BUDGET, burnin_wf=10, nsamples_wf=20))
    kb, ks = jax.random.split(jax.random.split(jax.random.PRNGKey(3), 3)[2])
    keys = jnp.concatenate([jax.random.split(kb, kw["burnin_wf"]),
                            jax.random.split(ks, kw["nsamples_wf"])])
    noise = _step_noise(keys, (B, N, L))
    drawn = []

    def jax_noise(n_steps, rows, l, generator, device):
        assert (n_steps, rows, l) == tuple(noise.shape[:2]) + (L,)
        drawn.append(n_steps)
        return noise.to(device)

    monkeypatch.setattr(tmcem, "make_chain_noise", jax_noise)
    _against_both(p, "run_peem_wf", kw, 1e-3)
    assert drawn == [kw["burnin_wf"] + kw["nsamples_wf"]]


def test_enhancer_default_config_matches_jax(shared_nmf_init):  # noqa: F811
    """The port's Enhancer at the default McemConfig (fast_stats and the
    bf16 decoder) apart from budgets and a frozen chain, against the JAX
    Enhancer at its default; and against JAX at fast_stats=False, from
    which every utterance differs by more than the tolerance."""
    jm = jmodels.VAE(x_dim=513, z_dim=16, h_dim=(32, 32))
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     jnp.ones((4, 513)))
    tm = tmodels.VAE(513, 16, (32, 32))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    budget = dict(niter=3, nsamples_e_step=2, burnin_e_step=2, nsamples_wf=2, burnin_wf=2,
                  var_rw=0.0)
    ws = wavs()
    tcfg = EnhancerConfig(mcem=tmcem.McemConfig(**budget), wire_dtype="float32")
    assert tcfg.mcem.fast_stats and tcfg.mcem.fast_decoder
    tout = Enhancer(tm, tcfg, device="cpu").enhance_batch(ws, seed=0)
    jouts = {stats: JaxEnhancer(jm, params, JaxEnhancerConfig(
        mcem=jmcem.McemConfig(**budget, fast_stats=stats), wire_dtype="float32")).enhance_batch(
            ws, key=jax.random.PRNGKey(0)) for stats in (True, False)}
    for i, x in enumerate(ws):
        ts, tn = tout[i]
        assert ts.shape == tn.shape == x.shape and np.isfinite(ts).all()
        js, jn = jouts[True][i]
        tol = 5e-4 * (np.abs(js).max() + 1e-9)
        np.testing.assert_allclose(ts, js, atol=tol)
        np.testing.assert_allclose(tn, jn, atol=tol)
        assert np.abs(ts - jouts[False][i][0]).max() > tol


def test_estep_emits_bf16_and_planes_must_match_the_flag(p):
    """On the CPU the E-step segment emits bf16 samples under fast_stats;
    run_mh_chain raises TypeError where a plane's dtype does not match
    the flag and the mode (x2 bf16; Vb bf16 in E-step mode, f32 in WF
    mode; both f32 without the flag)."""
    mats = extract_decoder_mlp(p["tm"], L)
    x2 = torch.from_numpy(p["x2"].reshape(ROWS, F))
    vb = torch.from_numpy(p["vb"].reshape(ROWS, F))
    g = torch.from_numpy(p["g"].reshape(ROWS))
    z0 = torch.from_numpy(p["z0"].reshape(ROWS, L))
    noise = mh_chain.make_chain_noise(3, ROWS, L, torch.Generator().manual_seed(0), "cpu")
    half = (x2.to(torch.bfloat16), vb.to(torch.bfloat16))
    z, s = run_mh_chain(mats, *half, g, z0, None, noise, 1, 2, 0.01, fast_stats=True)
    assert s.dtype == torch.bfloat16 and s.shape == (2, ROWS, F) and z.dtype == torch.float32
    _, wfs, wfn = run_mh_chain(mats, half[0], vb, g, z0, None, noise, 1, 2, 0.01, True,
                               fast_stats=True)
    assert wfs.dtype == wfn.dtype == torch.float32
    np.testing.assert_allclose((wfs + wfn).numpy(), 2.0, rtol=1e-6)
    bad = [((x2, half[1]), False, True, "x2 must be bfloat16"),
           ((half[0], vb), False, True, "vb must be bfloat16"),
           (half, True, True, "vb must be float32"),
           ((half[0], vb), False, False, "x2 must be float32"),
           ((x2, half[1]), False, False, "vb must be float32")]
    for planes, wf_mode, stats, said in bad:
        with pytest.raises(TypeError, match=said):
            run_mh_chain(mats, *planes, g, z0, None, noise, 1, 2, 0.01, wf_mode,
                         fast_stats=stats)
