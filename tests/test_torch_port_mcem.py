"""Port parity: ``run_mcem`` against the JAX kernel path.

JAX runs ``run_mcem(use_pallas=True, pallas_interpret=True)`` with the
all-f32 config; both packages get the same ``nmf_init``. With a frozen
chain (var_rw = 0) the whole run is deterministic, so cost, masks, W, H
and g must agree to float tolerance (rtol 1e-4: different summation orders,
compounded over the multiplicative NMF updates). With live proposals the
two draw different noise, so the check is statistical, as in
tests/test_mcem.py: cost trajectories and mask statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvae_tpu.enhance.mcem import McemConfig as JaxMcemConfig
from dvae_tpu.enhance.mcem import run_mcem as jax_run_mcem
from dvae_tpu.enhance.pallas_mcem import extract_decoder_mlp as jax_extract
from dvae_tpu.models import VAE as JaxVAE
from dvae_tpu_torch.enhance.mcem import McemConfig, fold_seed, make_generators, run_mcem
from dvae_tpu_torch.enhance.mh_chain import extract_decoder_mlp
from dvae_tpu_torch.models import VAE
from dvae_tpu_torch.models.convert import state_dict_from_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

B, N, F, L, K = 2, 16, 65, 8, 4
BUDGET = dict(nsamples_e_step=3, burnin_e_step=2, nsamples_wf=4, burnin_wf=2, nmf_rank=K)


@pytest.fixture(scope="module")
def problem():
    jm = JaxVAE(x_dim=F, z_dim=L, h_dim=(32, 32))
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     jnp.ones((4, F)))
    tm = VAE(F, L, (32, 32))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    rng = np.random.default_rng(0)
    z_true = rng.standard_normal((B, N, L)).astype(np.float32)
    vs = np.asarray(jm.apply(params, jnp.asarray(z_true), method="decode"))
    vb = 0.5 + 0.1 * rng.uniform(size=(B, N, F))
    x2 = ((vs + vb) * rng.standard_normal((B, N, F)) ** 2 + 1e-3).astype(np.float32)
    z0 = (0.5 * rng.standard_normal((B, N, L))).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 11:] = 0.0
    w = np.maximum(rng.uniform(size=(B, F, K)), 1e-8).astype(np.float32)
    h = np.maximum(rng.uniform(size=(B, N, K)), 1e-8).astype(np.float32)
    g = np.ones((B, N), np.float32)
    return jm, params, tm, x2, z0, mask, (w, h, g)


def _run_jax(problem, cfg_kw, seed):
    jm, params, _, x2, z0, mask, nmf = problem
    dec = lambda zin: jm.apply(params, zin, method="decode")  # noqa: E731
    cfg = JaxMcemConfig(**cfg_kw, fast_stats=False, fast_decoder=False)
    res = jax_run_mcem(dec, jnp.asarray(x2), jnp.asarray(z0), jnp.asarray(mask),
                       jax.random.PRNGKey(seed), cfg, nmf_init=tuple(map(jnp.asarray, nmf)),
                       decoder_mats=jax_extract(params, L), use_pallas=True,
                       pallas_interpret=True)
    return [np.asarray(a) for a in res]


def _run_port(problem, cfg_kw, seed):
    _, _, tm, x2, z0, mask, nmf = problem
    res = run_mcem(extract_decoder_mlp(tm, L), torch.from_numpy(x2), torch.from_numpy(z0),
                   torch.from_numpy(mask), seed, McemConfig(**cfg_kw, fast_decoder=False),
                   nmf_init=tuple(map(torch.from_numpy, nmf)))
    return [a.numpy() for a in res]


def test_frozen_chain_matches_jax(problem):
    kw = dict(niter=6, var_rw=0.0, **BUDGET)
    jr, pr = _run_jax(problem, kw, 3), _run_port(problem, kw, 3)
    for name, a, b in zip(("wfs", "wfn", "cost", "z", "w", "h", "g"), jr, pr):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6, err_msg=name)
    # padded frames are exactly zero, and the Wiener partition holds
    mask = problem[5]
    assert np.abs(pr[0][1, 11:]).max() == 0.0
    np.testing.assert_allclose((pr[0] + pr[1])[mask > 0], 1.0, atol=1e-5)


def test_live_chain_statistics_match_jax(problem):
    kw = dict(niter=12, var_rw=0.01, **BUDGET)
    mask = problem[5] > 0
    jr, pr = _run_jax(problem, kw, 5), _run_port(problem, kw, 5)
    jcost, pcost = jr[2], pr[2]
    assert np.isfinite(pcost).all() and pcost[-1] < pcost[0]
    np.testing.assert_allclose(pcost[-1], jcost[-1], rtol=0.02)
    assert abs(pr[0][mask].mean() - jr[0][mask].mean()) < 0.05
    assert abs(pr[0][mask].std() - jr[0][mask].std()) < 0.05
    np.testing.assert_allclose((pr[0] + pr[1])[mask], 1.0, atol=1e-5)
    assert (pr[0] >= 0).all() and (pr[0] <= 1 + 1e-5).all()


def test_seed_streams_are_independent_and_deterministic():
    assert fold_seed(0, 1) == fold_seed(0, 1)
    assert len({fold_seed(0, i) for i in range(3)} | {fold_seed(1, 0)}) == 4
    a = [torch.rand(4, generator=gn) for gn in make_generators(11, "cpu")]
    b = [torch.rand(4, generator=gn) for gn in make_generators(11, "cpu")]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])


def test_m1_reference_effective_budgets():
    for cls in (McemConfig, JaxMcemConfig):
        c = cls.m1_reference_effective(niter=7, var_rw=0.0)
        assert (c.niter, c.nsamples_e_step, c.burnin_e_step, c.nsamples_wf,
                c.burnin_wf, c.var_rw) == (7, 30, 30, 75, 30, 0.0)
    import dataclasses

    assert [f.name for f in dataclasses.fields(McemConfig)] == \
        [f.name for f in dataclasses.fields(JaxMcemConfig)]
    assert McemConfig() == McemConfig(**{
        f.name: getattr(JaxMcemConfig(), f.name) for f in dataclasses.fields(JaxMcemConfig)})
