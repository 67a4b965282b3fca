"""Port parity: ``enhance/labeling.py`` against the JAX package's.

``self_soft_labels`` runs each family's own x -> y classifier on the power
spectrogram of ragged noisy wavs (one shorter than a frame) zero-padded to
the longest; the port's spectrogram is the plain version of the STFT power
kernel on the CPU. Sigmoid outputs in [0, 1] through f32 products on both
sides agree to 1e-5 absolute, with and without the std_norm statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dvae_tpu.enhance.labeling as jlab
import dvae_tpu.models as jmodels
import dvae_tpu_torch.enhance.labeling as tlab
import dvae_tpu_torch.models as tmodels
from dvae_tpu.ops.stft import StftConfig as JaxStftConfig
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.ops import stft_power
from dvae_tpu_torch.ops.stft import StftConfig, n_stft_frames_clamped
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

FAMILY = {"v3": "CVAE_v3", "v4": "CVAE_v4", "v5": "DisentangledVAE"}
LENGTHS = (9000, 16000, 700, 12345)


def _wavs():
    rng = np.random.default_rng(0)
    return [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in LENGTHS]


@pytest.mark.parametrize("y_dim", [1, 513])
@pytest.mark.parametrize("norm", [False, True], ids=["raw", "norm"])
@pytest.mark.parametrize("family", list(FAMILY))
def test_self_soft_labels_match_jax(family, norm, y_dim):
    name = FAMILY[family]
    jm = getattr(jmodels, name)(x_dim=513, y_dim=y_dim, z_dim=16, h_dim=(32, 32))
    params = jmodels.init_params(jm, {"params": jax.random.PRNGKey(1),
                                      "sample": jax.random.PRNGKey(2)},
                                 jnp.ones((2, 513)), jnp.ones((2, y_dim)))
    tm = getattr(tmodels, name)(513, y_dim, 16, (32, 32))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    stats = None
    if norm:
        rng = np.random.default_rng(3)
        stats = (rng.uniform(0.0, 5.0, (513, 1)).astype(np.float32),
                 rng.uniform(1.0, 20.0, (513, 1)).astype(np.float32))
    method = tlab.classify_method_of(family)
    assert method == jlab.classify_method_of(family)
    ws = _wavs()
    want = jlab.self_soft_labels(jm, params, ws, JaxStftConfig(), y_dim, method, norm=stats)
    before = stft_power.launches
    got = tlab.self_soft_labels(tm, ws, StftConfig(), y_dim, method, norm=stats)
    assert stft_power.launches == before  # CPU tensors take the plain version
    assert len(got) == len(ws)
    for g, w, x in zip(got, want, ws):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert g.shape == (n_stft_frames_clamped(len(x), StftConfig()), y_dim)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_constant_labels_and_methods():
    for kind, value in (("ones", 1.0), ("zeros", 0.0)):
        got = tlab.constant_labels(7, 513, kind)
        np.testing.assert_array_equal(got, jlab.constant_labels(7, 513, kind))
        assert got.dtype == np.float32 and got.shape == (7, 513) and (got == value).all()
    with pytest.raises(ValueError, match="bad constant label kind"):
        tlab.constant_labels(3, 1, "half")
    assert tlab.CLASSIFY_METHOD == jlab.CLASSIFY_METHOD
    for family in ("m1", "m2", "m2v2"):
        assert tlab.classify_method_of(family) is None
