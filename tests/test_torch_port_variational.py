"""Port parity: ``models/variational.py`` (the KL warm-up, the
importance-weighted sampler, the labelled bound and the M2 SVI objective).

The same numpy inputs and weights go through both packages. The SVI loss
draws its noise inside the JAX model from ``rngs={"sample": key}``; the
test recovers that noise from the JAX encoder's own sample with the same
key, ``(z - mu) * exp(-0.5 * logvar)``, and hands it to the port as
``sample_eps``. Losses agree to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.models.variational as jv
import dvae_tpu_torch.models.variational as tv
from dvae_tpu.models import CVAE_v3 as JaxCVAE_v3
from dvae_tpu.models import init_params
from dvae_tpu_torch.models import CVAE_v3
from dvae_tpu_torch.models.convert import state_dict_from_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

F, Z, H = 64, 8, (16,)


@pytest.mark.parametrize("ramp", [(4, 1.0, 0.0), (4, 0.0, 1.0), (3, 2.0, 0.5)],
                         ids=["rising", "falling", "offset"])
def test_deterministic_warmup_matches_jax(ramp):
    got, want = tv.DeterministicWarmup(*ramp), jv.DeterministicWarmup(*ramp)
    assert [next(got) for _ in range(7)] == [next(want) for _ in range(7)]


def test_importance_weighted_sampler_and_labelled_loss_match_jax():
    rng = np.random.default_rng(0)
    s_t, s_j = tv.ImportanceWeightedSampler(mc=2, iw=3), jv.ImportanceWeightedSampler(mc=2, iw=3)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    np.testing.assert_array_equal(s_t.resample(torch.from_numpy(x)).numpy(),
                                  np.asarray(s_j.resample(jnp.asarray(x))))
    elbo = 3 * rng.standard_normal(24).astype(np.float32)
    got, want = s_t(torch.from_numpy(elbo)).numpy(), np.asarray(s_j(jnp.asarray(elbo)))
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-5)

    b = 8
    args = [rng.exponential(1.0, (b, F)).astype(np.float32) + 1e-3,
            rng.exponential(1.0, (b, F)).astype(np.float32) + 1e-3,
            rng.standard_normal((b, Z)).astype(np.float32),
            rng.standard_normal((b, Z)).astype(np.float32),
            rng.uniform(size=(b, 1)).astype(np.float32)]
    for beta in (1.0, 0.25):
        got = tv.labelled_loss(*map(torch.from_numpy, args), beta=beta).numpy()
        want = np.asarray(jv.labelled_loss(*map(jnp.asarray, args), beta=beta))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _models(saturate=False):
    jm = JaxCVAE_v3(x_dim=F, y_dim=1, z_dim=Z, h_dim=H)
    x = np.abs(np.random.default_rng(1).standard_normal((12, F))).astype(np.float32) + 0.1
    params = init_params(jm, {"params": jax.random.PRNGKey(1), "sample": jax.random.PRNGKey(2)},
                         jnp.asarray(x), jnp.ones((12, 1)))
    if saturate:  # the classifier saturates to exactly 1.0 in float32
        params = jax.tree_util.tree_map(lambda a: a, params)
        b = params["params"]["classifier"]["output_layer"]["bias"]
        params["params"]["classifier"]["output_layer"]["bias"] = b + 60.0
    tm = CVAE_v3(F, 1, Z, H)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm, x


def _noise(jm, params, x, key):
    """The noise the JAX model draws with ``key``, from its encoder's sample."""
    z, mu, lv = (np.asarray(a, np.float64) for a in jm.apply(
        params, jnp.asarray(x), method="encode", rngs={"sample": key}))
    return torch.from_numpy(((z - mu) * np.exp(-0.5 * lv)).astype(np.float32))


@pytest.mark.parametrize("labelled", [True, False], ids=["labelled", "unlabelled"])
@pytest.mark.parametrize("saturate", [False, True], ids=["live", "saturated"])
def test_svi_loss_matches_jax(labelled, saturate):
    jm, params, tm, x = _models(saturate)
    key = jax.random.PRNGKey(3)
    y = (np.arange(12) % 2).astype(np.float32)[:, None]
    if labelled:
        want, wm = jv.svi_loss(jm, params, jnp.asarray(x), jnp.asarray(y), key,
                               alpha=0.1, beta=0.5)
        eps = _noise(jm, params, x, key)
        got, gm = tv.svi_loss(tm, torch.from_numpy(x), torch.from_numpy(y), alpha=0.1,
                              beta=0.5, sample_eps=eps)
    else:
        want, wm = jax.jit(lambda p, xx, k: jv.svi_loss(jm, p, xx, None, k))(
            params, jnp.asarray(x), key)
        eps = tuple(_noise(jm, params, x, k) for k in jax.random.split(key, 2))
        got, gm = tv.svi_loss(tm, torch.from_numpy(x), None, sample_eps=eps)
    assert set(gm) == set(wm)
    got = float(got.detach())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    # the port's own generator draws work too, and the loss has a gradient
    got, _ = tv.svi_loss(tm, torch.from_numpy(x), None if not labelled else torch.from_numpy(y),
                         generator=torch.Generator().manual_seed(0))
    got.backward()
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters() if p.grad is not None)
