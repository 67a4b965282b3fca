"""Port parity: the M1 VAE against Flax through ``state_dict_from_jax``.

f32 dense layers on both sides: rtol 1e-5 on the encoder mean and 1e-5 on
the decoder's exp output (relative error of exp = absolute error of its
argument, ~1e-6 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvae_tpu.models import VAE as JaxVAE
from dvae_tpu.train.torch_import import export_torch_state_dict
from dvae_tpu_torch.models import VAE
from dvae_tpu_torch.models.blocks import init_xavier_
from dvae_tpu_torch.models.convert import state_dict_from_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", params=[(513, 16, (128, 128)), (513, 16, (64, 32))],
                ids=["m1", "nonsquare"])
def pair(request):
    x_dim, z_dim, h_dim = request.param
    jm = JaxVAE(x_dim=x_dim, z_dim=z_dim, h_dim=h_dim)
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     jnp.ones((4, x_dim)))
    tm = VAE(x_dim, z_dim, h_dim)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


def test_state_dict_names_shapes_and_export_agree(pair):
    jm, params, tm = pair
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params))
    ref = export_torch_state_dict(params)
    assert set(sd) == set(ref) == set(tm.state_dict())
    assert "encoder.hidden.0.weight" in sd and "decoder.reconstruction.bias" in sd
    assert "encoder.sample.mu.weight" in sd and "encoder.sample.log_var.bias" in sd
    for k in sd:
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), ref[k].numpy())


def test_strict_load_rejects_a_wrong_family(pair):
    _, params, _ = pair
    bad = VAE(513, 8, (128, 128))
    with pytest.raises(RuntimeError):
        bad.load_state_dict(state_dict_from_jax(params), strict=True)
    with pytest.raises(ValueError, match="non-Dense"):
        state_dict_from_jax({"params": {"bn": {"mean": np.zeros(3)}}})


def test_encode_decode_match_flax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(0)
    x = np.abs(rng.standard_normal((7, 513))).astype(np.float32)
    z = rng.standard_normal((7, 16)).astype(np.float32)
    jz, jmu, jlv = (np.asarray(a) for a in jm.apply(params, jnp.asarray(x), method="encode",
                                                     sample=False))
    with torch.no_grad():
        tz, tmu, tlv = (a.numpy() for a in tm.encode(torch.from_numpy(x), sample=False))
        tdec = tm.decode(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(tz, tmu)
    np.testing.assert_allclose(tmu, jmu, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tlv, jlv, rtol=1e-5, atol=1e-6)
    jdec = np.asarray(jm.apply(params, jnp.asarray(z), method="decode"))
    np.testing.assert_allclose(tdec, jdec, rtol=1e-5)


def test_sampled_encode_uses_its_generator():
    tm = VAE(513, 16, (32, 32))
    x = torch.rand((5, 513))
    a = tm.encode(x, sample=True, generator=torch.Generator().manual_seed(1))[0]
    b = tm.encode(x, sample=True, generator=torch.Generator().manual_seed(1))[0]
    assert torch.equal(a, b)
    init_xavier_(tm, torch.Generator().manual_seed(3))
    w1 = tm.decoder.hidden[0].weight.clone()
    init_xavier_(tm, torch.Generator().manual_seed(3))
    assert torch.equal(w1, tm.decoder.hidden[0].weight)
    assert not tm.decoder.hidden[0].bias.detach().any()
