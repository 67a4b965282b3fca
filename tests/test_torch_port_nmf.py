"""Port parity: the masked NMF M-step against ``dvae_tpu.enhance.nmf``.

f32 on both sides with the same inputs; one multiplicative step agrees to
rtol 1e-5 (summation order only), several chained steps to rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import torch

from dvae_tpu.enhance import nmf as jnmf
from dvae_tpu_torch.enhance import nmf as tnmf

R, B, N, F, K = 3, 2, 20, 65, 4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x2 = (rng.uniform(size=(B, N, F)) ** 2 + 1e-3).astype(np.float32)
    vs = (rng.uniform(size=(R, B, N, F)) + 0.05).astype(np.float32)
    w = np.maximum(rng.uniform(size=(B, F, K)), 1e-8).astype(np.float32)
    h = np.maximum(rng.uniform(size=(B, N, K)), 1e-8).astype(np.float32)
    g = rng.uniform(0.5, 1.5, size=(B, N)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 13:] = 0.0
    return x2, vs, w, h, g, mask


def _both(x2, vs, w, h, g, mask, steps):
    jw, jh, jg = map(jnp.asarray, (w, h, g))
    tw, th, tg = map(torch.from_numpy, (w, h, g))
    for _ in range(steps):
        jw, jh, jg, jvb = jnmf.nmf_m_step(jnp.asarray(x2), jnp.asarray(vs), jw, jh, jg,
                                           jnp.asarray(mask))
        tw, th, tg, tvb = tnmf.nmf_m_step(torch.from_numpy(x2), torch.from_numpy(vs),
                                           tw, th, tg, torch.from_numpy(mask))
    return [np.asarray(a) for a in (jw, jh, jg, jvb)], [a.numpy() for a in (tw, th, tg, tvb)]


def test_m_step_matches_jax():
    for steps, rtol in ((1, 1e-5), (5, 1e-4)):
        j, t = _both(*_inputs(), steps)
        for name, a, b in zip("whgv", j, t):
            np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-7, err_msg=f"{name}@{steps}")


def test_padded_frames_do_not_touch_w():
    x2, vs, w, h, g, mask = _inputs(1)
    x2b, vsb = x2.copy(), vs.copy()
    x2b[1, 13:] = 1e3  # garbage in padded frames
    vsb[:, 1, 13:] = 7.0
    _, a = _both(x2, vs, w, h, g, mask, 1)
    _, b = _both(x2b, vsb, w, h, g, mask, 1)
    np.testing.assert_allclose(b[0], a[0], rtol=1e-5)


def test_silent_utterance_stays_finite_and_matches_jax():
    x2, vs, w, h, g, mask = _inputs(2)
    x2[0] = 0.0  # digitally silent utterance
    j, t = _both(x2, vs, w, h, g, mask, 3)
    for a, b in zip(j, t):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-7)


def test_init_and_compute_vb():
    gen = torch.Generator().manual_seed(0)
    w, h, g = tnmf.init_nmf(gen, B, N, F, K, 0.5)
    assert w.shape == (B, F, K) and h.shape == (B, N, K) and g.shape == (B, N)
    assert float(w.min()) >= 0.5 and float(h.min()) >= 0.5 and bool((g == 1).all())
    _, _, w0, h0, _, _ = _inputs()
    np.testing.assert_allclose(
        tnmf.compute_vb(torch.from_numpy(w0), torch.from_numpy(h0)).numpy(),
        np.asarray(jnmf.compute_vb(jnp.asarray(w0), jnp.asarray(h0))), rtol=1e-6)
    assert tnmf.VX_FLOOR == jnmf.VX_FLOOR
