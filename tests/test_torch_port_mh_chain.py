"""Port parity: the port's MH chain against the JAX Pallas kernel.

The JAX kernel runs through the Pallas interpreter (``interpret=True``,
``tile=16``); the port's chain takes the very same noise, rebuilt here from
the JAX key exactly as ``pallas_mcem.run_mh_chain`` draws it. ROWS is a
multiple of the tile, so the JAX noise has no padded rows. Tolerance
rtol 2e-4 / atol 1e-5: the two frameworks sum in different orders (~1e-6
relative per decoder pass), and the chain compounds it over a few steps;
with the same noise an acceptance flip would show as an O(1) error.

``fast_decoder=True`` (bf16 operands, f32 sums) is held against the JAX
package's ``make_mlp_decoder(fast=True)`` at M1 widths. Both round the same
operands to bf16 the same way (to nearest even) and their products are
exact, so they differ only in the order of the f32 sums; where that puts a
tanh output within rounding of a bf16 rounding boundary, it rounds the
other way, and its row's Vs moves by up to ~1e-3 relative. So the limits
are: 5e-3 relative on every element, and 1e-5 relative on at least 99% of
them (about 0.4% differ at these weights).

The CUDA kernel itself is held against the plain chain on the card in
test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvae_tpu.enhance.mcem import make_mlp_decoder
from dvae_tpu.enhance.pallas_mcem import extract_decoder_mlp as jax_extract
from dvae_tpu.enhance.pallas_mcem import run_mh_chain as jax_chain
from dvae_tpu.models import CVAE as JaxCVAE
from dvae_tpu.models import VAE as JaxVAE
from dvae_tpu_torch.enhance.mh_chain import (
    DecoderMats,
    _fold_bias,
    decoder_reference,
    extract_decoder_mlp,
    run_mh_chain,
)
from dvae_tpu_torch.models import VAE
from dvae_tpu_torch.models.convert import state_dict_from_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

B, N, F, L = 2, 24, 513, 16
ROWS = B * N
RTOL, ATOL = 2e-4, 1e-5


def jax_noise(key, n_steps, rows, l):
    """The noise run_mh_chain draws from ``key`` (rows already tile-aligned)."""
    k_eps, k_u = jax.random.split(key)
    eps = jax.random.normal(k_eps, (n_steps, rows, l), jnp.float32)
    log_u = jnp.log(jax.random.uniform(k_u, (n_steps, rows, 1), minval=1e-38))
    return torch.from_numpy(np.array(jnp.concatenate([eps, log_u], axis=-1)))


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def mats_from_jax(jmats):
    """The port's ``DecoderMats`` of the JAX package's two-hidden-layer
    tuple ``(w1z, w1y, b1, w2, b2, w3, b3)``."""
    w1z, w1y, b1, w2, b2, w3, b3 = (None if m is None else t(m) for m in jmats)
    return DecoderMats(w1z, w1y, b1, ((w2, b2),), w3, b3)


def mats_tensors(mats):
    """Every array of a ``DecoderMats`` in order (``w1y`` None when absent),
    for comparing two of them."""
    return [mats.w1z, mats.w1y, mats.b1, *(a for layer in mats.hidden for a in layer),
            mats.w_out, mats.b_out]


def problem(seed, h_dim=(32, 32)):
    """Flax VAE + its converted port twin + numpy-seeded chain inputs."""
    jm = JaxVAE(x_dim=F, z_dim=L, h_dim=h_dim)
    params = jm.init({"params": jax.random.PRNGKey(seed),
                      "sample": jax.random.PRNGKey(seed + 1)}, jnp.ones((4, F)))
    tm = VAE(F, L, h_dim)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    rng = np.random.default_rng(seed)
    x2 = (rng.uniform(size=(ROWS, F)) + 0.05).astype(np.float32)
    vb = (rng.uniform(size=(ROWS, F)) + 0.05).astype(np.float32)
    g = rng.uniform(0.5, 1.5, size=ROWS).astype(np.float32)
    z0 = (0.1 * rng.standard_normal((ROWS, L))).astype(np.float32)
    return jm, params, tm, x2, vb, g, z0


@pytest.fixture(scope="module")
def m1():
    return problem(0)


def run_both(jmats, tmats, x2, vb, g, z0, y, key, n_burn, n_samples, var_rw, wf_mode):
    jout = jax_chain(jmats, jnp.asarray(x2), jnp.asarray(vb), jnp.asarray(g),
                     jnp.asarray(z0), None if y is None else jnp.asarray(y), key,
                     n_burn=n_burn, n_samples=n_samples, var_rw=var_rw,
                     wf_mode=wf_mode, interpret=True, tile=16)
    noise = jax_noise(key, n_burn + n_samples, x2.shape[0], z0.shape[-1])
    tout = run_mh_chain(tmats, t(x2), t(vb), t(g), t(z0), None if y is None else t(y),
                        noise, n_burn, n_samples, var_rw, wf_mode=wf_mode)
    return [np.asarray(a) for a in jout], [a.numpy() for a in tout]


def test_extract_decoder_mlp_matches_jax(m1):
    _, params, tm, *_ = m1
    jm = jax_extract(params, L)
    pm = extract_decoder_mlp(tm, L)
    assert pm.w1y is None and jm[1] is None
    for a, b in zip(mats_tensors(mats_from_jax(jm)), mats_tensors(pm)):
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # one hidden layer: the JAX kernel has no weights for it, the port's
    # kernel takes it (depths 1 to 8, ROADMAP A10)
    one = extract_decoder_mlp(VAE(F, L, (32,)), L)
    assert one.widths == (32,) and one.hidden == () and one.w_out.shape == (32, F)


@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_frozen_chain_matches_jax(m1, wf_mode):
    _, params, tm, x2, vb, g, z0 = m1
    (jz, *jrest), (pz, *prest) = run_both(
        jax_extract(params, L), extract_decoder_mlp(tm, L), x2, vb, g, z0, None,
        jax.random.PRNGKey(0), 2, 3, 0.0, wf_mode)
    np.testing.assert_array_equal(pz, z0)  # a frozen chain never moves
    np.testing.assert_allclose(jz, z0, rtol=1e-6)
    for a, b in zip(jrest, prest):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    if not wf_mode:
        vs0 = tm.decode(t(z0)).detach().numpy()
        for r in range(3):
            np.testing.assert_allclose(prest[0][r], vs0, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("wf_mode,key", [(False, 42), (True, 7)], ids=["estep", "wf"])
def test_live_chain_matches_jax(m1, wf_mode, key):
    _, params, tm, x2, vb, g, z0 = m1
    (jz, *jrest), (pz, *prest) = run_both(
        jax_extract(params, L), extract_decoder_mlp(tm, L), x2, vb, g, z0, None,
        jax.random.PRNGKey(key), 3, 2, 0.01, wf_mode)
    assert np.mean(np.any(pz != z0, axis=-1)) > 0.5  # the chain explores
    np.testing.assert_allclose(pz, jz, rtol=RTOL, atol=ATOL)
    for a, b in zip(jrest, prest):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def _cvae_mats(seed, h_dim=(32, 32)):
    model = JaxCVAE(x_dim=F, y_dim=2, z_dim=L, h_dim=h_dim)
    params = model.init({"params": jax.random.PRNGKey(seed),
                         "sample": jax.random.PRNGKey(seed + 1)},
                        jnp.ones((4, F)), jnp.ones((4, 2)))
    return model, params, jax_extract(params, L)


def test_conditioned_chain_matches_jax(m1):
    """y folded into the first-layer row bias == the concat([z, y]) decoder."""
    *_, x2, vb, g, z0 = m1
    model, params, jmats = _cvae_mats(5)
    y = (np.random.default_rng(3).uniform(size=(ROWS, 2)) > 0.5).astype(np.float32)
    (jz, js), (pz, ps) = run_both(jmats, mats_from_jax(jmats), x2, vb, g, z0, y,
                                  jax.random.PRNGKey(1), 2, 2, 0.01, False)
    np.testing.assert_allclose(ps, js, rtol=RTOL, atol=ATOL)
    _, (_, p0) = run_both(jmats, mats_from_jax(jmats), x2, vb, g, z0, y,
                          jax.random.PRNGKey(0), 0, 1, 0.0, False)
    want = np.asarray(model.apply(params, jnp.concatenate([z0, y], axis=-1),
                                  method="decode"))
    np.testing.assert_allclose(p0[0], want, rtol=2e-5, atol=1e-6)


def test_conditioning_mismatch_raises(m1):
    *_, tm, x2, vb, g, z0 = m1
    noise = torch.zeros((1, ROWS, L + 1))
    args = (t(x2), t(vb), t(g), t(z0))
    with pytest.raises(ValueError, match="conditioning mismatch"):
        run_mh_chain(extract_decoder_mlp(tm, L), *args, torch.ones((ROWS, 2)), noise, 0, 1, 0.0)
    _, _, jmats = _cvae_mats(8)
    with pytest.raises(ValueError, match="conditioning mismatch"):
        run_mh_chain(mats_from_jax(jmats), *args, None, noise, 0, 1, 0.0)


def test_bad_inputs_raise(m1):
    *_, tm, x2, vb, g, z0 = m1
    mats = extract_decoder_mlp(tm, L)
    noise = torch.zeros((2, ROWS, L + 1))
    with pytest.raises(ValueError, match="noise has shape"):
        run_mh_chain(mats, t(x2), t(vb), t(g), t(z0), None, noise, 0, 1, 0.0)
    with pytest.raises(TypeError, match="float32"):
        run_mh_chain(mats, t(x2).double(), t(vb), t(g), t(z0), None, noise[:1], 0, 1, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        run_mh_chain(mats, t(x2), t(vb), t(g), t(z0).t().contiguous().t(), None,
                     noise[:1], 0, 1, 0.0)


def test_non_square_hidden_stack_matches_jax():
    """h_dim (64, 32) gives a (32, 64) decoder: each layer's true width."""
    jm, params, tm, x2, vb, g, z0 = problem(3, h_dim=(64, 32))
    (jz, js), (pz, ps) = run_both(jax_extract(params, L), extract_decoder_mlp(tm, L),
                                  x2, vb, g, z0, None, jax.random.PRNGKey(2), 2, 2,
                                  0.01, False)
    np.testing.assert_allclose(ps, js, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pz, jz, rtol=RTOL, atol=ATOL)


def assert_bf16_close(got, want):
    """The fast_decoder limits of the module docstring."""
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() < 5e-3, rel.max()
    assert (rel < 1e-5).mean() >= 0.99, (rel < 1e-5).mean()


@pytest.mark.parametrize("conditioned", [False, True], ids=["m1", "conditioned"])
def test_fast_decoder_matches_jax(conditioned):
    """The plain bf16 decoder against make_mlp_decoder(fast=True), M1
    widths; conditioned on soft labels (not exact in bf16), whose product
    the port folds into the first layer's row bias."""
    rows = 512
    rng = np.random.default_rng(11)
    z = rng.standard_normal((rows, L)).astype(np.float32)
    if conditioned:
        _, _, jmats = _cvae_mats(4, h_dim=(128, 128))
        y = rng.uniform(size=(rows, 2)).astype(np.float32)
        zin = np.concatenate([z, y], axis=-1)
    else:
        _, params, *_ = problem(4, h_dim=(128, 128))
        jmats, y, zin = jax_extract(params, L), None, z
    want = np.asarray(make_mlp_decoder(jmats, fast=True)(jnp.asarray(zin)))
    tmats = mats_from_jax(jmats)
    by = _fold_bias(tmats, None if y is None else t(y), rows, fast_decoder=True)
    got = decoder_reference(tmats, by, fast_decoder=True)(t(z)).numpy()
    assert_bf16_close(got, want)
    # the f32 decoder is further off than the bf16 rounding flips
    f32 = decoder_reference(tmats, _fold_bias(tmats, None if y is None else t(y), rows))(t(z))
    assert np.abs(f32.numpy() / want - 1).max() > 1e-3


@pytest.mark.parametrize("wf_mode", [False, True], ids=["estep", "wf"])
def test_fast_frozen_chain_matches_jax_decoder(wf_mode):
    """A frozen chain at fast_decoder=True emits make_mlp_decoder(fast=True)
    of its z every step (E-step), or sums its Wiener ratios (WF)."""
    _, params, tm, x2, vb, g, z0 = problem(6, h_dim=(128, 128))
    vs = np.asarray(make_mlp_decoder(jax_extract(params, L), fast=True)(jnp.asarray(z0)))
    noise = jax_noise(jax.random.PRNGKey(3), 3, ROWS, L)
    pz, *out = run_mh_chain(extract_decoder_mlp(tm, L), t(x2), t(vb), t(g), t(z0), None,
                            noise, 1, 2, 0.0, wf_mode=wf_mode, fast_decoder=True)
    np.testing.assert_array_equal(pz.numpy(), z0)
    if wf_mode:
        vsc = g[:, None] * vs
        vx = np.maximum(vsc + vb, 1e-10)
        np.testing.assert_allclose(out[0].numpy(), 2 * vsc / vx, rtol=5e-3)
        np.testing.assert_allclose(out[1].numpy(), 2 * vb / vx, rtol=5e-3)
    else:
        for r in range(2):
            assert_bf16_close(out[0][r].numpy(), vs)
