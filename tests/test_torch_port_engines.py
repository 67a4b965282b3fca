"""Port parity: the E-step engines beside ``run_mcem`` against the JAX ones.

``run_em_fixed_z``, ``run_peem``, ``run_peem_wf`` and ``run_pmcem`` of the
port against their JAX counterparts (the XLA scan engines), all-f32
configs (``fast_stats=False, fast_decoder=False``), both packages given the
same ``nmf_init``. Where the run is deterministic (the pinned latent,
PEEM, and a frozen chain, var_rw = 0, for peem-wf and pmcem: pmcem's
chains then all sit at ``z_init``), cost, masks, latent, W, H and g agree
to rtol 1e-4 (different summation orders, compounded over the
multiplicative NMF updates and, for PEEM, the Adam steps), with an
absolute floor of 1e-6, and of 1e-5 for the latent: its values are O(1)
and cross zero, so an element near zero has no meaningful relative error. Live chains
draw different noise in the two packages, so they are checked
statistically, as in test_torch_port_mcem.py. Each engine runs
unconditioned (M1's ``VAE``) and conditioned (``CVAE_v2``, labels in the
decoder only).

PEEM's gradient: the port differentiates its plain decoder with autograd,
JAX with ``jax.grad``; in bf16 (``fast_decoder=True``) both round the
cotangents to bf16 at the same casts, and agree to 1e-6 relative (they
were bitwise equal on the CPU when this test was written).
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
from dvae_tpu.enhance.pallas_mcem import extract_decoder_mlp as jax_extract
from dvae_tpu_torch.enhance import mh_chain
from dvae_tpu_torch.enhance.mh_chain import decoder_reference, extract_decoder_mlp
from dvae_tpu_torch.models.convert import state_dict_from_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

B, N, F, L, K, Y = 2, 16, 65, 8, 4, 3
BUDGET = dict(nsamples_e_step=3, burnin_e_step=2, nsamples_wf=4, burnin_wf=2, nmf_rank=K,
              peem_steps=3, pmcem_chains=3, pmcem_steps=2, pmcem_wf_burn=2)
NAMES = ("wfs", "wfn", "cost", "z", "w", "h", "g")
ATOL = {"z": 1e-5}
ENGINES = ("run_em_fixed_z", "run_peem", "run_peem_wf", "run_pmcem")


def _models(cond):
    init = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    if cond:
        jm = jmodels.CVAE_v2(x_dim=F, y_dim=Y, z_dim=L, h_dim=(32, 32))
        params = jmodels.init_params(jm, init, jnp.ones((4, F)), jnp.ones((4, Y)))
        tm = tmodels.CVAE_v2(F, Y, L, (32, 32))
    else:
        jm = jmodels.VAE(x_dim=F, z_dim=L, h_dim=(32, 32))
        params = jm.init(init, jnp.ones((4, F)))
        tm = tmodels.VAE(F, L, (32, 32))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


@functools.cache
def _problem(cond):
    jm, params, tm = _models(cond)
    rng = np.random.default_rng(0)
    y = rng.uniform(size=(B, N, Y)).astype(np.float32) if cond else None
    z_true = rng.standard_normal((B, N, L)).astype(np.float32)
    zin = z_true if y is None else np.concatenate([z_true, y], -1)
    vs = np.asarray(jm.apply(params, jnp.asarray(zin), method="decode"))
    vb = 0.5 + 0.1 * rng.uniform(size=(B, N, F))
    x2 = ((vs + vb) * rng.standard_normal((B, N, F)) ** 2 + 1e-3).astype(np.float32)
    z0 = (0.5 * rng.standard_normal((B, N, L))).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 11:] = 0.0
    w = np.maximum(rng.uniform(size=(B, F, K)), 1e-8).astype(np.float32)
    h = np.maximum(rng.uniform(size=(B, N, K)), 1e-8).astype(np.float32)
    g = np.ones((B, N), np.float32)
    return dict(jm=jm, params=params, tm=tm, x2=x2, z0=z0, mask=mask, y=y, nmf=(w, h, g))


@pytest.fixture(params=[False, True], ids=["m1", "cond"])
def problem(request):
    return _problem(request.param)


def run_jax(p, engine, cfg_kw, seed, fast=False):
    jm, params = p["jm"], p["params"]
    cfg = jmcem.McemConfig(**cfg_kw, fast_stats=False, fast_decoder=fast)
    args = (lambda zin: jm.apply(params, zin, method="decode"), jnp.asarray(p["x2"]),
            jnp.asarray(p["z0"]), jnp.asarray(p["mask"]))
    kw = dict(y=None if p["y"] is None else jnp.asarray(p["y"]),
              nmf_init=tuple(map(jnp.asarray, p["nmf"])),
              decoder_mats=jax_extract(params, L))
    key = jax.random.PRNGKey(seed)
    if engine == "run_pmcem":
        res = jmcem.run_pmcem(*args, key, cfg, **kw)
    else:
        res = getattr(jmcem, engine)(*args, cfg, key=key, **kw)
    return [np.asarray(a) for a in res]


def run_port(p, engine, cfg_kw, seed, fast=False):
    y = None if p["y"] is None else torch.from_numpy(p["y"])
    res = getattr(tmcem, engine)(
        extract_decoder_mlp(p["tm"], L), torch.from_numpy(p["x2"]), torch.from_numpy(p["z0"]),
        torch.from_numpy(p["mask"]), seed,
        tmcem.McemConfig(**cfg_kw, fast_stats=False, fast_decoder=fast), y,
        tuple(map(torch.from_numpy, p["nmf"])))
    return [a.detach().numpy() for a in res]


def _partition_and_padding(p, res):
    mask = p["mask"]
    wfs, wfn = res[0], res[1]
    assert np.abs(wfs[1, 11:]).max() == 0.0 and np.abs(wfn[1, 11:]).max() == 0.0
    np.testing.assert_allclose((wfs + wfn)[mask > 0], 1.0, atol=1e-5)


@pytest.mark.parametrize("engine", ENGINES)
def test_deterministic_engines_match_jax(problem, engine):
    """The pinned latent, PEEM, and frozen peem-wf / pmcem: every output at
    rtol 1e-4; the port launches nothing on the CPU."""
    kw = dict(niter=5, var_rw=0.0, **BUDGET)
    before = mh_chain.launches
    jr, pr = run_jax(problem, engine, kw, 3), run_port(problem, engine, kw, 3)
    assert mh_chain.launches == before
    for name, a, b in zip(NAMES, jr, pr):
        assert b.shape == a.shape, name
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=ATOL.get(name, 1e-6), err_msg=name)
    _partition_and_padding(problem, pr)


def test_peem_zero_steps_is_fixed_z(problem):
    """peem_steps=0 leaves the latent at z_init: the port's run_peem is then
    its run_em_fixed_z exactly, and both match JAX's run_em_fixed_z."""
    kw = dict(niter=4, **dict(BUDGET, peem_steps=0))
    peem = run_port(problem, "run_peem", kw, 1)
    fixed = run_port(problem, "run_em_fixed_z", dict(kw, peem_steps=4), 1)
    for name, a, b in zip(NAMES, fixed, peem):
        np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(peem[3], problem["z0"])
    for name, a, b in zip(NAMES, run_jax(problem, "run_em_fixed_z", kw, 1), fixed):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6, err_msg=name)


def test_peem_moves_the_latent_and_lowers_the_cost(problem):
    """PEEM's latent leaves z_init, and its final cost lies below the
    pinned-latent EM's on the same init (both packages agree on that)."""
    kw = dict(niter=6, **BUDGET)
    peem = run_port(problem, "run_peem", kw, 0)
    fixed = run_port(problem, "run_em_fixed_z", kw, 0)
    assert np.abs(peem[3] - problem["z0"]).max() > 1e-3
    assert peem[2][-1] < fixed[2][-1]
    assert np.isfinite(peem[2]).all() and (np.diff(peem[2]) < 0).all()


@pytest.mark.parametrize("engine", ["run_peem_wf", "run_pmcem"])
def test_live_engines_statistics_match_jax(problem, engine):
    """Live chains (var_rw 0.01): peem-wf's EM trajectory is PEEM's, so its
    cost, W, H and g still agree at rtol 1e-4; its masks, and everything of
    pmcem, agree statistically (final cost within 2%, mask mean and spread
    within 0.05), with the Wiener partition exact."""
    kw = dict(niter=10, var_rw=0.01, **BUDGET)
    mask = problem["mask"] > 0
    jr, pr = run_jax(problem, engine, kw, 5), run_port(problem, engine, kw, 5)
    if engine == "run_peem_wf":
        for name in ("cost", "w", "h", "g"):
            i = NAMES.index(name)
            np.testing.assert_allclose(pr[i], jr[i], rtol=1e-4, atol=1e-6, err_msg=name)
    assert np.isfinite(pr[2]).all() and pr[2][-1] < pr[2][0]
    np.testing.assert_allclose(pr[2][-1], jr[2][-1], rtol=0.02)
    assert abs(pr[0][mask].mean() - jr[0][mask].mean()) < 0.05
    assert abs(pr[0][mask].std() - jr[0][mask].std()) < 0.05
    _partition_and_padding(problem, pr)
    assert (pr[0] >= 0).all() and (pr[0] <= 1 + 1e-5).all()
    # the chains moved: the latent left z_init
    assert np.abs(pr[3] - problem["z0"])[mask].max() > 1e-3


def test_pmcem_chains_are_independent_rows(problem):
    """pmcem's R chains are independent rows of one segment: with R = 1 and
    one step per EM iteration it is a one-chain MCEM whose E-step keeps the
    last of its samples, so its cost and latent move like mcem's."""
    kw = dict(niter=6, var_rw=0.01, **dict(BUDGET, pmcem_chains=1, pmcem_steps=1))
    pr = run_port(problem, "run_pmcem", kw, 2)
    assert pr[3].shape == (B, N, L)
    assert np.isfinite(pr[2]).all() and pr[2][-1] < pr[2][0]
    _partition_and_padding(problem, pr)


def test_peem_bf16_gradient_matches_jax_grad():
    """The bf16 decoder's energy gradient: autograd through the port's
    plain decoder against ``jax.grad`` through ``make_mlp_decoder(fast=True)``
    (unconditioned weights of the problem's model)."""
    problem = _problem(False)
    mats = extract_decoder_mlp(problem["tm"], L)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((B * N, L)).astype(np.float32)
    vb = rng.uniform(0.1, 1.0, (B * N, F)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (B * N,)).astype(np.float32)
    x2 = problem["x2"].reshape(B * N, F)
    jdec = jmcem.make_mlp_decoder(jax_extract(problem["params"], L), fast=True)

    def energy(z):
        vx = jnp.maximum(g[:, None] * jdec(z) + vb, 1e-10)
        return jnp.sum(jnp.log(vx) + x2 / vx) + 0.5 * jnp.sum(z * z)

    want = np.asarray(jax.grad(energy)(jnp.asarray(z)))
    dec = decoder_reference(mats, mats[2], True)
    zt = torch.from_numpy(z).requires_grad_(True)
    vx = (torch.from_numpy(g)[:, None] * dec(zt) + torch.from_numpy(vb)).clamp_min(1e-10)
    e = (torch.log(vx) + torch.from_numpy(x2) / vx).sum() + 0.5 * (zt * zt).sum()
    got = torch.autograd.grad(e, zt)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_peem_bf16_decoder_matches_jax():
    """run_peem with the bf16 decoder (``fast_decoder=True``) on both sides,
    unconditioned: every output at rtol 1e-4 and atol 1e-5. The looser
    floor (1e-5, not 1e-6) is for bf16 rounding: an f32-level difference in
    a latent that lies on a bf16 rounding boundary rounds it the other way
    at the next decode. (The conditioned bf16 fold sums ``y @ w1y`` in
    another order, so it is held by the f32 parity above and by
    test_torch_port_cvae.py's decoder check.)"""
    problem = _problem(False)
    kw = dict(niter=5, **BUDGET)
    jr, pr = run_jax(problem, "run_peem", kw, 0, True), run_port(problem, "run_peem", kw, 0, True)
    for name, a, b in zip(NAMES, jr, pr):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=name)


def test_engines_share_the_seeds_nmf_init(problem):
    """Without an nmf_init, every engine draws the same one from its seed
    (the first stream), so the pinned-latent EM and frozen peem-wf, whose
    EM loops are identical at peem_steps=0, agree exactly."""
    y = None if problem["y"] is None else torch.from_numpy(problem["y"])
    cfg = tmcem.McemConfig(niter=3, var_rw=0.0, fast_decoder=False,
                           **dict(BUDGET, peem_steps=0))
    args = (extract_decoder_mlp(problem["tm"], L), torch.from_numpy(problem["x2"]),
            torch.from_numpy(problem["z0"]), torch.from_numpy(problem["mask"]), 9, cfg, y)
    fixed, hybrid = tmcem.run_em_fixed_z(*args), tmcem.run_peem_wf(*args)
    for name in ("cost", "w", "h", "g"):
        assert torch.equal(getattr(fixed, name), getattr(hybrid, name)), name
    torch.testing.assert_close(hybrid.wfs, fixed.wfs, rtol=1e-5, atol=1e-6)
