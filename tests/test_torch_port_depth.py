"""Port parity at any decoder depth and width (ROADMAP A10, A10b) and the
BatchNorm classifier (A16), against the JAX package, at F 65, L 8 and 32
frame rows.

The JAX package builds decoders of any depth and width; its Pallas kernel
and its bf16 decoder take two hidden layers only, so at any other depth it
runs its scan engines on the Flax decoder in f32 (``extract_decoder_mlp``
gives None, and ``_prep_em`` swaps in no bf16 decoder). The port runs every
depth, none and past 8 too, and every width through its chain (the kernel's
f32 body on the card, the plain chain here), in f32 at any depth but 2
whatever ``fast_decoder`` says. So:

* the plain chain is held against JAX's scan step (``mcem._make_mh_step``)
  on the Flax decoder, fed the noise rebuilt from the keys of that step,
  frozen and live, E-step samples and WF sums, at rtol 2e-4 / atol 1e-5 (as
  test_torch_port_mh_chain.py: summation order, compounded over the steps;
  an acceptance flip would show as an O(1) error), at depth 0 (M1 and
  conditioned), 1, 3, 9 and 16, odd widths and a width of 1024; the bf16
  chain at 1024 1024 against the step on JAX's ``make_mlp_decoder(fast=True)``
  by test_torch_port_mh_chain.py's bf16 rule;
* every engine, frozen or deterministic, with a shared NMF init and the
  port's ``fast_decoder=True``, at rtol 1e-4 (atol 1e-6, 1e-5 for the
  latent, as test_torch_port_engines.py) against JAX's, and bitwise equal
  to the port's own ``fast_decoder=False`` run;
* the frozen ``Enhancer`` at depth 3 with the default ``fast_decoder``, its
  waveforms within 1e-4 of the peak of JAX's (as test_torch_port_pipeline.py),
  and so at depth 0, depth 9 and width 513 (the decoders the port refused
  before); at ``--h-dim 1024 1024``, the bf16 route, within
  ``BF16_WAVE_TOL`` of the peak;
* ``Classifier(batch_norm=True)`` against Flax in both modes, outputs and
  updated running statistics at rtol 1e-5.

The card's machine has no JAX: there only this file's ``cuda`` tests run
(``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_depth.py``), each body against its plain chain with
test_torch_port_cuda.py's tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dvae_tpu_torch.enhance.mcem as tmcem
import dvae_tpu_torch.models as tmodels
from dvae_tpu_torch.enhance import mh_chain
from dvae_tpu_torch.enhance.mh_chain import (
    DecoderMats,
    decoder_reference,
    extract_decoder_mlp,
    make_chain_noise,
    mh_chain_reference,
    pad_decoder_f32,
    run_mh_chain,
)
from dvae_tpu_torch.enhance.pipeline import Enhancer, EnhancerConfig
from dvae_tpu_torch.models.convert import state_dict_from_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

try:  # the card's machine has no JAX; only the cuda tests run there
    import jax
    import jax.numpy as jnp

    import dvae_tpu.enhance.mcem as jmcem
    import dvae_tpu.models as jmodels
    from dvae_tpu.enhance.pallas_mcem import extract_decoder_mlp as jax_extract
    from dvae_tpu.enhance.pipeline import Enhancer as JaxEnhancer
    from dvae_tpu.enhance.pipeline import EnhancerConfig as JaxEnhancerConfig
except ImportError:
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="the parity tests need the JAX package")

B, N, F, L, K, Y = 2, 16, 65, 8, 4, 3
ROWS = B * N
DEPTHS = {"d1": (24,), "d3": (32, 16, 8), "odd": (31, 17), "d0": (), "d9": (32,) * 9,
          "d16": (32,) * 16, "w1024": (1024,)}
BUDGET = dict(nsamples_e_step=3, burnin_e_step=2, nsamples_wf=4, burnin_wf=2, nmf_rank=K,
              peem_steps=3, pmcem_chains=3, pmcem_steps=2, pmcem_wf_burn=2)
NAMES = ("wfs", "wfn", "cost", "z", "w", "h", "g")
ENGINES = ("run_mcem", "run_em_fixed_z", "run_peem", "run_peem_wf", "run_pmcem")


def _models(h_dim, cond, f=F, l=L, seed=0):
    init = {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1)}
    if cond:
        jm = jmodels.CVAE_v2(x_dim=f, y_dim=Y, z_dim=l, h_dim=h_dim)
        params = jmodels.init_params(jm, init, jnp.ones((4, f)), jnp.ones((4, Y)))
        tm = tmodels.CVAE_v2(f, Y, l, h_dim)
    else:
        jm = jmodels.VAE(x_dim=f, z_dim=l, h_dim=h_dim)
        params = jm.init(init, jnp.ones((4, f)))
        tm = tmodels.VAE(f, l, h_dim)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


def _problem(h_dim, cond, seed=0):
    """Models and numpy-seeded EM inputs (frames past 11 of the second
    utterance padded)."""
    jm, params, tm = _models(h_dim, cond, seed=seed)
    rng = np.random.default_rng(seed)
    y = rng.uniform(size=(B, N, Y)).astype(np.float32) if cond else None
    z_true = rng.standard_normal((B, N, L)).astype(np.float32)
    zin = z_true if y is None else np.concatenate([z_true, y], -1)
    vs = np.asarray(jm.apply(params, jnp.asarray(zin), method="decode"))
    vb = (0.5 + 0.1 * rng.uniform(size=(B, N, F))).astype(np.float32)
    x2 = ((vs + vb) * rng.standard_normal((B, N, F)) ** 2 + 1e-3).astype(np.float32)
    z0 = (0.5 * rng.standard_normal((B, N, L))).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 11:] = 0.0
    w = np.maximum(rng.uniform(size=(B, F, K)), 1e-8).astype(np.float32)
    h = np.maximum(rng.uniform(size=(B, N, K)), 1e-8).astype(np.float32)
    g = rng.uniform(0.5, 1.5, size=(B, N)).astype(np.float32)
    return dict(jm=jm, params=params, tm=tm, x2=x2, vb=vb, z0=z0, mask=mask, y=y,
                nmf=(w, h, g))


@needs_jax
@pytest.mark.parametrize("depth", DEPTHS, ids=list(DEPTHS))
def test_extract_decoder_mlp_at_any_depth(depth):
    """The first layer split at L, each further hidden layer, the output
    layer: the Flax decoder's Dense weights, transposed back; with no hidden
    layer the output layer is the first. JAX's own extraction serves two
    hidden layers only."""
    from test_torch_port_mh_chain import mats_from_jax, mats_tensors

    _, params, tm = _models(DEPTHS[depth], False)
    dec = params["params"]["decoder"]
    hidden = dec.get("hidden", {})
    layers = [*(hidden[f"layers_{i}"] for i in range(len(hidden))), dec["reconstruction"]]
    mats = extract_decoder_mlp(tm, L)
    assert mats.widths == tuple(reversed(DEPTHS[depth])) and mats.w1y is None
    last = (layers[-1]["kernel"], layers[-1]["bias"]) if len(layers) > 1 else (None, None)
    want = [layers[0]["kernel"], None, layers[0]["bias"],
            *(a for lay in layers[1:-1] for a in (lay["kernel"], lay["bias"])), *last]
    for a, b in zip(want, mats_tensors(mats), strict=True):
        assert (a is None) == (b is None)
        if a is not None:
            assert b.is_contiguous() and b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jm = jax_extract(params, L)
    if len(mats.widths) == 2:
        for a, b in zip(mats_tensors(mats_from_jax(jm)), mats_tensors(mats)):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    else:
        assert jm is None


def test_f32_padding_keeps_the_decoder():
    """The f32 body's host padding (a zero unit per odd width) leaves the
    decoder's output as it is, bit for bit."""
    tm = tmodels.VAE(F, L, (31, 17, 9))
    mats = extract_decoder_mlp(tm, L)
    layers, w_out, b_out = pad_decoder_f32(mats)
    widths = tuple(w.shape[1] for w, _ in layers)
    assert widths == (10, 18, 32) and w_out.shape == (32, F)
    b1 = torch.nn.functional.pad(mats.b1, (0, 1))
    padded = DecoderMats(layers[0][0], None, b1, layers[1:], w_out, b_out)
    z = torch.randn((ROWS, L), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(decoder_reference(padded, b1)(z), decoder_reference(mats, mats.b1)(z))
        torch.testing.assert_close(decoder_reference(mats, mats.b1)(z), tm.decode(z))


def _jax_chain(p, keys, n_burn, var_rw, wf_mode, decoder=None):
    """JAX's scan step on the Flax decoder (or ``decoder``) over ``keys``:
    the final z, and the accepted Vs of each post-burn-in step (E-step) or
    their Wiener sums (WF)."""
    jm, params = p["jm"], p["params"]
    x2, vb = jnp.asarray(p["x2"]), jnp.asarray(p["vb"])
    g = jnp.asarray(p["nmf"][2])
    y = None if p["y"] is None else jnp.asarray(p["y"])
    dec, energy, step, _ = jmcem._make_mh_step(
        decoder or (lambda zin: jm.apply(params, zin, method="decode")), x2, y, var_rw)
    z = jnp.asarray(p["z0"])
    vs = dec(z)
    carry = (z, vs, energy(z, vs, vb, g))
    out, wfs, wfn = [], 0.0, 0.0
    for k, key in enumerate(keys):
        carry, _ = step(carry, key, vb, g)
        if k >= n_burn:
            vs = carry[1]
            if wf_mode:
                vsc = g[:, :, None] * vs
                vx = jnp.maximum(vsc + vb, 1e-10)
                wfs, wfn = wfs + vsc / vx, wfn + vb / vx
            else:
                out.append(vs)
    z = np.asarray(carry[0]).reshape(ROWS, L)
    if wf_mode:
        return [z, np.asarray(wfs).reshape(ROWS, F), np.asarray(wfn).reshape(ROWS, F)]
    return [z, np.asarray(jnp.stack(out)).reshape(len(out), ROWS, F)]


def _noise_of(keys):
    """The noise the JAX step draws from each key: ``split(key)``, then
    ``normal(k1, z.shape)`` and ``log(uniform(k2, minval=1e-38))``, as the
    port's (n_steps, rows, L + 1) rows."""
    steps = []
    for key in keys:
        k1, k2 = jax.random.split(key)
        eps = jax.random.normal(k1, (B, N, L)).reshape(ROWS, L)
        log_u = jnp.log(jax.random.uniform(k2, (B, N), minval=1e-38)).reshape(ROWS, 1)
        steps.append(jnp.concatenate([eps, log_u], -1))
    return torch.from_numpy(np.array(jnp.stack(steps)))


CHAIN_CASES = [("m1", "d1"), ("m1", "d3"), ("m1", "odd"), ("cond", "d3"), ("m1", "d0"),
               ("cond", "d0"), ("m1", "d9"), ("m1", "d16"), ("m1", "w1024")]


@needs_jax
@pytest.mark.parametrize("family,depth", CHAIN_CASES, ids=[f"{f}-{d}" for f, d in CHAIN_CASES])
@pytest.mark.parametrize("var_rw", [0.0, 0.01], ids=["frozen", "live"])
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_plain_chain_matches_jax_step(family, depth, var_rw, wf_mode):
    p = _problem(DEPTHS[depth], family == "cond", seed=1)
    n_burn, n_samples = 2, 3
    keys = jax.random.split(jax.random.PRNGKey(4), n_burn + n_samples)
    want = _jax_chain(p, keys, n_burn, var_rw, wf_mode)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    y = None if p["y"] is None else t(p["y"].reshape(ROWS, Y))
    got = mh_chain_reference(extract_decoder_mlp(p["tm"], L), t(p["x2"].reshape(ROWS, F)),
                             t(p["vb"].reshape(ROWS, F)), t(p["nmf"][2].reshape(ROWS)),
                             t(p["z0"].reshape(ROWS, L)), y, _noise_of(keys), n_burn, n_samples,
                             var_rw, wf_mode)
    if var_rw == 0.0:
        np.testing.assert_array_equal(got[0].numpy(), p["z0"].reshape(ROWS, L))
    else:  # the chain moved
        assert np.abs(got[0].numpy() - p["z0"].reshape(ROWS, L)).max() > 1e-3
    for a, b in zip(want, got, strict=True):
        np.testing.assert_allclose(b.numpy(), a, rtol=2e-4, atol=1e-5)


def _bf16_share(units: int) -> float:
    """The share of bf16-route elements that must agree within 1e-5 for a
    decoder of ``units`` hidden units: 0.99 up to 256 units (as
    test_torch_port_mh_chain.py at 128 128), the allowance growing in
    proportion beyond, as ``chip_smoke.py::bf16_share_limit`` scales it. A
    row's Vs moves when any one of its units rounds to the other side of a
    bf16 boundary, so the rows that move grow with the units (2.1% of the
    elements at 1024 1024 here)."""
    return 1.0 - 0.01 * max(1.0, units / 256)


@needs_jax
@pytest.mark.parametrize("var_rw", [0.0, 0.01], ids=["frozen", "live"])
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_plain_bf16_chain_at_1024_matches_jax_fast_step(var_rw, wf_mode):
    """The bf16 route at ``--h-dim 1024 1024``: the plain chain at
    ``fast_decoder=True`` against JAX's scan step on
    ``make_mlp_decoder(fast=True)`` of the same weights (JAX's own
    extraction serves two hidden layers at any width), fed the same noise.
    The latents by the f32 chain's limits (the energy stays f32); the
    samples and WF sums by test_torch_port_mh_chain.py's bf16 rule, 5e-3
    relative on every element, with the share within 1e-5 scaled to the
    units (:func:`_bf16_share`)."""
    p = _problem((1024, 1024), False, seed=2)
    jmats = jax_extract(p["params"], L)
    assert jmats is not None
    n_burn, n_samples = 2, 3
    keys = jax.random.split(jax.random.PRNGKey(5), n_burn + n_samples)
    want = _jax_chain(p, keys, n_burn, var_rw, wf_mode, jmcem.make_mlp_decoder(jmats, fast=True))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    mats = extract_decoder_mlp(p["tm"], L)
    assert mats.widths == (1024, 1024)
    got = mh_chain_reference(mats, t(p["x2"].reshape(ROWS, F)), t(p["vb"].reshape(ROWS, F)),
                             t(p["nmf"][2].reshape(ROWS)), t(p["z0"].reshape(ROWS, L)), None,
                             _noise_of(keys), n_burn, n_samples, var_rw, wf_mode,
                             fast_decoder=True)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=2e-4, atol=1e-5)
    for a, b in zip(want[1:], got[1:], strict=True):
        rel = np.abs(b.numpy() - a) / np.abs(a)
        assert rel.max() < 5e-3, rel.max()
        assert (rel < 1e-5).mean() >= _bf16_share(2048), (rel < 1e-5).mean()


@needs_jax
@pytest.mark.parametrize("cond", [False, True], ids=["m1", "cond"])
@pytest.mark.parametrize("depth", ["d1", "d3", "d0", "d9"])
@pytest.mark.parametrize("engine", ENGINES)
def test_engines_match_jax_at_any_depth(engine, depth, cond):
    """Frozen (var_rw = 0) or deterministic runs of every engine: the port
    with ``fast_decoder=True`` against JAX's f32 scan engines, and equal to
    its own f32 run (the precision rule); the Wiener partition holds and
    padded frames are 0."""
    p = _problem(DEPTHS[depth], cond)
    kw = dict(niter=4, var_rw=0.0, **BUDGET)
    jcfg = jmcem.McemConfig(**kw, fast_stats=False, fast_decoder=True)
    jargs = (lambda zin: p["jm"].apply(p["params"], zin, method="decode"),
             jnp.asarray(p["x2"]), jnp.asarray(p["z0"]), jnp.asarray(p["mask"]))
    jkw = dict(y=None if p["y"] is None else jnp.asarray(p["y"]),
               nmf_init=tuple(map(jnp.asarray, p["nmf"])),
               decoder_mats=jax_extract(p["params"], L))
    assert jkw["decoder_mats"] is None  # so JAX runs its Flax decoder in f32
    key = jax.random.PRNGKey(3)
    if engine in ("run_mcem", "run_pmcem"):
        jr = getattr(jmcem, engine)(*jargs, key, jcfg, **jkw)
    else:
        jr = getattr(jmcem, engine)(*jargs, jcfg, key=key, **jkw)

    mats = extract_decoder_mlp(p["tm"], L)
    y = None if p["y"] is None else torch.from_numpy(p["y"])
    before = mh_chain.launches
    runs = [getattr(tmcem, engine)(
        mats, torch.from_numpy(p["x2"]), torch.from_numpy(p["z0"]),
        torch.from_numpy(p["mask"]), 3,
        tmcem.McemConfig(**kw, fast_stats=False, fast_decoder=fast), y,
        tuple(map(torch.from_numpy, p["nmf"]))) for fast in (True, False)]
    assert mh_chain.launches == before
    for name, a, b, c in zip(NAMES, jr, *runs, strict=True):
        assert torch.equal(b, c), name
        b = b.detach().numpy()
        assert b.shape == np.asarray(a).shape, name
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                   atol=1e-5 if name == "z" else 1e-6, err_msg=name)
    wfs, wfn = runs[0].wfs.numpy(), runs[0].wfn.numpy()
    assert np.abs(wfs[1, 11:]).max() == 0.0 and np.abs(wfn[1, 11:]).max() == 0.0
    np.testing.assert_allclose((wfs + wfn)[p["mask"] > 0], 1.0, atol=1e-5)


def _wavs(seed=0, lengths=(16000, 11000, 600, 13500)):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        harm = sum(np.sin(2 * np.pi * (120 + 30 * i) * k * t) / k for k in range(1, 6))
        out.append((0.2 * harm + 0.05 * rng.standard_normal(n)).astype(np.float32))
    return out


@needs_jax
def test_frozen_enhancer_at_depth_3_matches_jax(monkeypatch):
    """A depth-3 model through both Enhancers with the default
    ``fast_decoder`` (so f32 on both sides), a frozen chain and a shared
    NMF init: waveforms within 1e-4 of the peak, the partition s + n = x."""
    def draw(batch, n_frames, n_freq, rank, eps):
        rng = np.random.default_rng(batch * 1000 + n_frames)
        return (np.maximum(rng.uniform(size=(batch, n_freq, rank)), eps).astype(np.float32),
                np.maximum(rng.uniform(size=(batch, n_frames, rank)), eps).astype(np.float32),
                np.ones((batch, n_frames), np.float32))

    monkeypatch.setattr(jmcem, "init_nmf", lambda key, *a: tuple(map(jnp.asarray, draw(*a))))
    monkeypatch.setattr(tmcem, "init_nmf", lambda gen, *a, device=None: tuple(
        torch.from_numpy(m).to(device) for m in draw(*a)))
    jm, params, tm = _models((32, 16, 8), False, f=513, l=16)
    budget = dict(niter=3, nsamples_e_step=2, burnin_e_step=2, nsamples_wf=2, burnin_wf=2,
                  var_rw=0.0)
    ws = _wavs()
    jcfg = JaxEnhancerConfig(mcem=jmcem.McemConfig(**budget, fast_stats=False),
                             wire_dtype="float32")
    jout = JaxEnhancer(jm, params, jcfg).enhance_batch(ws, key=jax.random.PRNGKey(0))
    tcfg = EnhancerConfig(mcem=tmcem.McemConfig(**budget, fast_stats=False),
                          wire_dtype="float32")
    assert tcfg.mcem.fast_decoder and jcfg.mcem.fast_decoder
    enh = Enhancer(tm, tcfg, device="cpu")
    assert enh.mats.widths == (8, 16, 32)
    before = mh_chain.launches
    tout = enh.enhance_batch(ws, seed=0)
    assert mh_chain.launches == before
    for (js, jn), (ts, tn), x in zip(jout, tout, ws, strict=True):
        assert ts.shape == tn.shape == x.shape
        peak = np.abs(js).max() + 1e-9
        np.testing.assert_allclose(ts, js, atol=1e-4 * peak)
        np.testing.assert_allclose(tn, jn, atol=1e-4 * peak)
        np.testing.assert_allclose(ts + tn, x, atol=1e-4 * np.abs(x).max())
    assert np.isfinite(enh.last_cost).all()


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


def _frozen_enhancers(h_dim, ws, budget, l=16):
    """Both Enhancers at the default ``fast_decoder`` on a ``VAE(513, l,
    h_dim)`` of the same weights, a frozen chain at f32 planes: (JAX's
    outputs, the port's Enhancer, the port's outputs, its launches)."""
    jm, params, tm = _models(h_dim, False, f=513, l=l)
    budget = dict(budget, var_rw=0.0)
    jcfg = JaxEnhancerConfig(mcem=jmcem.McemConfig(**budget, fast_stats=False),
                             wire_dtype="float32")
    jout = JaxEnhancer(jm, params, jcfg).enhance_batch(ws, key=jax.random.PRNGKey(0))
    tcfg = EnhancerConfig(mcem=tmcem.McemConfig(**budget, fast_stats=False),
                          wire_dtype="float32")
    assert tcfg.mcem.fast_decoder and jcfg.mcem.fast_decoder
    enh = Enhancer(tm, tcfg, device="cpu")
    before = mh_chain.launches
    tout = enh.enhance_batch(ws, seed=0)
    return jout, enh, tout, mh_chain.launches - before


# the bf16 route's waveforms against JAX's, relative to each utterance's
# peak, as test_torch_port_fast_stats.py holds the default Enhancer: both
# round the same operands to bf16, and a unit whose f32 sum lies within
# rounding of a bf16 boundary rounds to either side in the two packages;
# at 2 x 1024 units ~2% of the Vs elements move, each by up to ~1e-3
# relative (measured here: 2.1e-5 of the peak)
BF16_WAVE_TOL = 5e-4


@needs_jax
@pytest.mark.parametrize("h_dim", [(), (32,) * 9, (513,)], ids=["depth0", "depth9", "width513"])
def test_former_a10b_decoders_build_and_match_jax(h_dim, shared_nmf_init):
    """Depth 0, depth 9 and width 513, which the port refused before, build
    an ``Enhancer`` (on the CPU, and before the device is resolved) and
    enhance as JAX's does: frozen chain, f32 on both sides (depth 1 of 513
    runs f32 too), waveforms finite and within 1e-4 of the peak, the
    partition. The mixtures are quiet (peak ~0.05): with no tanh layer
    before its exp, a random decoder's Vs overflows to inf in both packages
    at full scale, where the encoder's mean grows with the power."""
    ws = [0.05 * w for w in _wavs(lengths=(9000, 4000))]
    budget = dict(niter=2, nsamples_e_step=2, burnin_e_step=1, nsamples_wf=2, burnin_wf=1)
    jout, enh, tout, n = _frozen_enhancers(h_dim, ws, budget, l=8)
    assert enh.mats.widths == tuple(reversed(h_dim)) and n == 0
    for (js, jn), (ts, tn), x in zip(jout, tout, ws, strict=True):
        assert np.isfinite(js).all() and np.isfinite(ts).all() and np.isfinite(tn).all()
        peak = np.abs(js).max() + 1e-9
        np.testing.assert_allclose(ts, js, atol=1e-4 * peak)
        np.testing.assert_allclose(tn, jn, atol=1e-4 * peak)
        np.testing.assert_allclose(ts + tn, x, atol=1e-4 * np.abs(x).max())


def test_bf16_body_refuses_other_depths():
    """The bf16 body serves two hidden layers, as the JAX package's bf16
    decoder does: other depths are refused, not sent to the plain chain
    (the engines clear ``fast_decoder`` there first)."""
    for h_dim in ((16, 16, 16), (), (16,)):
        mats = extract_decoder_mlp(tmodels.VAE(F, L, h_dim), L)
        x2 = torch.ones((ROWS, F))
        with pytest.raises(ValueError, match="the bf16 body serves two hidden layers"):
            run_mh_chain(mats, x2, x2, torch.ones(ROWS), torch.zeros((ROWS, L)), None,
                         torch.zeros((1, ROWS, L + 1)), 0, 1, 0.0, fast_decoder=True)


@needs_jax
def test_frozen_enhancer_at_1024_1024_bf16_matches_jax(shared_nmf_init):
    """``--h-dim 1024 1024`` through both Enhancers at the default
    ``fast_decoder=True``, the bf16 route on both sides (JAX's
    ``make_mlp_decoder(fast=True)``, the port's bf16 plain chain here, its
    tensor-core body on the card): waveforms within ``BF16_WAVE_TOL`` of
    the peak, the partition s + n = x."""
    ws = _wavs(lengths=(8000, 5000))
    budget = dict(niter=2, nsamples_e_step=2, burnin_e_step=1, nsamples_wf=2, burnin_wf=1)
    jout, enh, tout, n = _frozen_enhancers((1024, 1024), ws, budget)
    assert enh.mats.widths == (1024, 1024) and n == 0
    for (js, jn), (ts, tn), x in zip(jout, tout, ws, strict=True):
        assert np.isfinite(js).all() and np.isfinite(ts).all() and np.isfinite(tn).all()
        peak = np.abs(js).max() + 1e-9
        np.testing.assert_allclose(ts, js, atol=BF16_WAVE_TOL * peak)
        np.testing.assert_allclose(tn, jn, atol=BF16_WAVE_TOL * peak)
        np.testing.assert_allclose(ts + tn, x, atol=1e-4 * np.abs(x).max())
    assert np.isfinite(enh.last_cost).all()


@needs_jax
@pytest.mark.parametrize("shape", [(12, 9), (3, 5, 9)], ids=["NH", "BTH"])
def test_batchnorm_classifier_matches_flax(shape):
    """``Classifier(batch_norm=True)`` converted with ``state_dict_from_jax``
    from randomized Flax variables: ``train=False`` on the running
    statistics, ``train=True`` on the batch's, with the running statistics
    Flax's ``mutable=["batch_stats"]`` call returns; a second train call
    moves them again, as a second Flax call does."""
    from dvae_tpu.models.blocks import Classifier as JaxClassifier

    rng = np.random.default_rng(1)
    jc = JaxClassifier(hidden=(7, 5), y_dim=3, batch_norm=True)
    x = rng.standard_normal(shape).astype(np.float32)
    variables = jc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.2 * rng.standard_normal(a.shape) ** 2).astype(np.float32),
        variables)
    tc = tmodels.Classifier(9, (7, 5), 3, batch_norm=True)
    tc.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert set(tc.state_dict()) >= {"bn.0.weight", "bn.1.running_var", "hidden.1.bias"}

    def close(got, want):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)

    with torch.no_grad():
        close(tc(torch.from_numpy(x)).numpy(), jc.apply(variables, jnp.asarray(x)))
        close(tc(torch.from_numpy(x), train=False).numpy(),
              jc.apply(variables, jnp.asarray(x), train=False))
        for _ in range(2):
            want, upd = jc.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
            close(tc(torch.from_numpy(x), train=True).numpy(), want)
            variables = {"params": variables["params"], **upd}
            sd = state_dict_from_jax(variables)
            for k, v in tc.state_dict().items():
                close(v.numpy(), sd[k].numpy())
    # the train flag, not nn.Module.training, picks the statistics
    tc.train()
    with torch.no_grad():
        close(tc(torch.from_numpy(x)).numpy(), jc.apply(variables, jnp.asarray(x)))


@needs_jax
def test_training_m1_deep_cli_matches_jax_script(tmp_path, monkeypatch, capsys):
    """``training_m1 --h-dim 24 16 8`` against the JAX script in process
    (the fitters replaced by recorders, as test_torch_port_train_cli.py
    does): the same model, run, config and fit arguments; then the port's
    CLI trains two epochs for real and its best ``.pt`` enhances on the CPU
    at depth 3."""
    from _ntcd_tree import make_raw_tree
    from dvae_tpu_torch.cli import training_m1
    from dvae_tpu_torch.data import builders as tbuilders
    from dvae_tpu_torch.train.checkpoint import best_checkpoint
    from test_torch_port_train_cli import OBJECTS, _model_desc, _run_jax, _run_port

    make_raw_tree(tmp_path / "raw", proc=tmp_path / "videos")
    root = tmp_path / "data"
    tbuilders.build_frame_dataset(tmp_path / "raw", root / "subset" / "processed",
                                  labels="vad_labels", device="cpu")
    argv = ["--data-root", str(root), "--models-root", "models", "--h-dim", "24", "16", "8"]
    cache = jax.config.jax_compilation_cache_dir
    try:
        jcall, jout = _run_jax(monkeypatch, capsys, "training_M1", argv)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    tcall, tout = _run_port(monkeypatch, capsys, "training_M1", argv)
    monkeypatch.undo()
    assert tout == jout and "hdim_024_016_008" in tout
    assert _model_desc(tcall["model"]) == _model_desc(jcall["model"])
    assert tcall["model"].h_dim == (24, 16, 8)
    assert dataclasses.asdict(tcall["cfg"]) == dataclasses.asdict(jcall["cfg"])
    assert ({k: v for k, v in tcall.items() if k not in OBJECTS}
            == {k: v for k, v in jcall.items() if k not in OBJECTS})

    _, hist = training_m1.main(["--data-root", str(root), "--models-root", str(tmp_path),
                                "--end-epoch", "3", "--batch-size", "16",
                                "--h-dim", "24", "16", "8", "--platform", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(h["valid"]["elbo"]) for h in hist)
    run = tmp_path / "ntcd_M1_nonorm_hdim_024_016_008_zdim_016_end_epoch_003"
    assert len(list(run.glob("M1_epoch_*_vloss_*.opt.pt"))) == 2
    model = tmodels.VAE(513, 16, (24, 16, 8))
    model.load_state_dict(torch.load(best_checkpoint(run, "M1"), map_location="cpu",
                                     weights_only=True))
    cfg = EnhancerConfig(mcem=tmcem.McemConfig(niter=2, nsamples_e_step=2, burnin_e_step=1,
                                               nsamples_wf=2, burnin_wf=1))
    out = Enhancer(model, cfg, device="cpu").enhance_batch(_wavs(lengths=(8000, 5000)))
    assert all(np.isfinite(s).all() and np.isfinite(n).all() for s, n in out)


# ---- on the card: each body against its plain chain (no JAX here)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_problem(dev, rows, h_dim, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tm = tmodels.VAE(513, 16, h_dim).to(dev)
    x2 = torch.rand((rows, 513), generator=gen, device=dev) + 0.05
    vb = torch.rand((rows, 513), generator=gen, device=dev) + 0.05
    g = torch.rand((rows,), generator=gen, device=dev) + 0.5
    z0 = 0.1 * torch.randn((rows, 16), generator=gen, device=dev)
    return extract_decoder_mlp(tm, 16), x2, vb, g, z0, gen


def _kernel_vs_plain(dev, h_dim, fast, wf_mode, rows=1000, cond=0, share=0.99):
    """Frozen: the outputs at rtol 1e-5 (f32) or by the bf16 rule; live:
    >= 99% of rows end at the same z, and their outputs agree at rtol 1e-4
    (f32) or by the bf16 rule (test_torch_port_cuda.py's tolerances: the
    bf16 outputs within 5e-3 relative, and a ``share`` of them within
    1e-5). ``cond``: that many soft labels folded into the first layer's
    row bias (with no hidden layer, the output layer's)."""
    mats, x2, vb, g, z0, gen = _card_problem(dev, rows, h_dim)
    y = None
    if cond:
        n1 = mats.w1z.shape[1]
        mats = mats._replace(w1y=0.3 * torch.randn((cond, n1), generator=gen, device=dev))
        y = torch.rand((rows, cond), generator=gen, device=dev)
    for var_rw in (0.0, 0.01):
        noise = make_chain_noise(8, rows, 16, gen, dev)
        args = (mats, x2, vb, g, z0, y, noise, 4, 4, var_rw, wf_mode, fast)
        before, before_mma = mh_chain.launches, mh_chain.launches_mma
        zk, *ok = run_mh_chain(*args)
        torch.cuda.synchronize()
        assert mh_chain.launches == before + 1 and mh_chain.launches_mma == before_mma + fast
        zr, *orf = mh_chain_reference(*args)
        same = (zk - zr).abs().amax(-1) < 1e-4
        assert same.float().mean() > (0.999 if var_rw == 0.0 else 0.99)
        for a, b in zip(ok, orf):
            a, b = a[..., same, :], b[..., same, :]
            if fast:
                rel = (a - b).abs() / b.abs().clamp_min(1e-30)
                assert float(rel.max()) < 5e-3
                assert float((rel < 1e-5).float().mean()) >= share
            else:
                torch.testing.assert_close(a, b, rtol=1e-5 if var_rw == 0.0 else 1e-4,
                                           atol=1e-6 if var_rw == 0.0 else 1e-5)
    return mats


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim", [(128,), (128, 128, 128), (100, 37, 9)],
                         ids=["d1", "d3", "odd"])
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_cuda_f32_body_any_depth_matches_plain(cuda, h_dim, wf_mode):
    _kernel_vs_plain(cuda, h_dim, False, wf_mode)


@pytest.mark.cuda
def test_cuda_bf16_body_wide_wf_matches_plain(cuda):
    """(256, 256) in WF mode does not fit one block's shared memory with
    the WF sums beside the planes: the lean layout serves it."""
    _kernel_vs_plain(cuda, (256, 256), True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim,fast", [((1024,), False), ((1024,) + (64,) * 8, False),
                                        ((2048, 2048), True)],
                         ids=["f32", "f32-table", "bf16"])
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_cuda_wide_layout_matches_plain(cuda, h_dim, fast, wf_mode):
    """Hidden activations that do not fit beside the planes run in the wide
    layout (a global scratch slot per resident block): 4,000 rows are 250
    tiles, more than the blocks resident at once, so blocks loop over
    tiles; the scratch is the same at ten times the rows. Nine layers
    (eight of 64, then 1024) read the device table."""
    share = _bf16_share(sum(h_dim)) if fast else 0.99
    mats = _kernel_vs_plain(cuda, h_dim, fast, wf_mode, rows=4000, share=share)
    assert mh_chain.chain_layout(mats, 513, 16, wf_mode, fast) == "wide"
    small, big = (mh_chain.wide_scratch_bytes(mats, r, 513, 16, wf_mode, fast, device=cuda)
                  for r in (4000, 40000))
    assert 0 < small == big < 4000 // 16 * mh_chain.wide_scratch_bytes(mats, 16, 513, 16,
                                                                        wf_mode, fast)


@pytest.mark.cuda
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_cuda_depth0_conditioned_matches_plain(cuda, wf_mode):
    """No hidden layer: the output layer reads z' and a (rows, F) row bias
    folded from two soft labels."""
    mats = _kernel_vs_plain(cuda, (), False, wf_mode, cond=2)
    assert mats.widths == () and mats.w1y.shape == (2, 513)


@pytest.mark.cuda
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_cuda_depth12_matches_plain(cuda, wf_mode):
    """Twelve hidden layers, past the depths the kernel carries in its
    arguments: the layers from the device table."""
    _kernel_vs_plain(cuda, (64,) * 11 + (96,), False, wf_mode)


@pytest.mark.cuda
@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_cuda_deep_lean_layout_matches_plain(cuda, wf_mode):
    """Nine layers of 640 from the device table, their activations beside
    planes that leave the WF sums and the row bias in global memory."""
    mats = _kernel_vs_plain(cuda, (640,) * 9, False, wf_mode)
    assert mh_chain.chain_layout(mats, 513, 16, wf_mode, False) == "lean"


@pytest.mark.cuda
def test_cuda_enhancer_at_1024_1024_runs_the_bf16_body(cuda, monkeypatch):
    """A default-config Enhancer at ``--h-dim 1024 1024``: niter + 1
    launches, all of the bf16 body, and no plain chain."""
    def plain(*args, **kw):
        raise AssertionError("the plain chain ran on CUDA tensors")

    monkeypatch.setattr(mh_chain, "mh_chain_reference", plain)
    cfg = EnhancerConfig(mcem=tmcem.McemConfig(niter=5))
    enh = Enhancer(tmodels.VAE(513, 16, (1024, 1024)), cfg)
    before, before_mma = mh_chain.launches, mh_chain.launches_mma
    out = enh.enhance_batch(_wavs(), seed=0)
    torch.cuda.synchronize()
    assert mh_chain.launches == before + cfg.mcem.niter + 1
    assert mh_chain.launches_mma == before_mma + cfg.mcem.niter + 1
    assert all(np.isfinite(s).all() and np.isfinite(n).all() for s, n in out)


@pytest.mark.cuda
def test_cuda_deep_enhancer_runs_the_f32_body(cuda, monkeypatch):
    """A default-config Enhancer on a depth-3 model: niter + 1 launches of
    the f32 body, none of the bf16 body, and no plain chain."""
    def plain(*args, **kw):
        raise AssertionError("the plain chain ran on CUDA tensors")

    monkeypatch.setattr(mh_chain, "mh_chain_reference", plain)
    cfg = EnhancerConfig(mcem=tmcem.McemConfig(niter=5))
    assert cfg.mcem.fast_decoder
    enh = Enhancer(tmodels.VAE(513, 16, (256, 128, 64)), cfg)
    before, before_mma = mh_chain.launches, mh_chain.launches_mma
    out = enh.enhance_batch(_wavs(), seed=0)
    torch.cuda.synchronize()
    assert mh_chain.launches == before + cfg.mcem.niter + 1
    assert mh_chain.launches_mma == before_mma
    assert all(np.isfinite(s).all() and np.isfinite(n).all() for s, n in out)
