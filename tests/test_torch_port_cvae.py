"""Port parity: the conditional families (``CVAE``, ``CVAE_v2``-``v4``,
``EncoderClassifier``, ``DisentangledVAE``) and the classifier blocks
against Flax through ``state_dict_from_jax``.

Names: the port's converter, the JAX package's ``export_torch_state_dict``
and the port model's own ``state_dict`` agree key for key and value for
value, and the port model strict-loads them. Outputs: f32 dense layers on
both sides, so encoder heads, decoder, classifiers and ``forward`` agree
to 1e-5 relative (atol 1e-6 for values near 0). The decoder with the
labels folded into the first layer's row bias in bf16 (the MCEM chain's
``fast_decoder``) is held against ``make_mlp_decoder(fast=True)`` of the
concatenated ``[z, y]`` by the bf16 rule of test_torch_port_mh_chain.py: 5e-3
relative everywhere, 1e-5 on at least 99% of the elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.models as jmodels
import dvae_tpu_torch.models as tmodels
from dvae_tpu.enhance.mcem import make_mlp_decoder
from dvae_tpu.enhance.pallas_mcem import extract_decoder_mlp as jax_extract
from dvae_tpu.train.torch_import import export_torch_state_dict
from dvae_tpu_torch.enhance.mh_chain import decoder_reference, extract_decoder_mlp, fold_conditioning
from dvae_tpu_torch.models.convert import state_dict_from_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_mh_chain import mats_from_jax, mats_tensors

X, Z, H = 513, 16, (32, 32)
FAMILIES = ["CVAE", "CVAE_v2", "CVAE_v3", "CVAE_v4", "DisentangledVAE", "EncoderClassifier"]
# family -> its methods beyond encode / decode
METHODS = {"CVAE_v3": ("classify",), "CVAE_v4": ("classify_from_x", "classify_from_z"),
           "DisentangledVAE": ("classify_from_x", "classify_from_z"),
           "EncoderClassifier": ("classify",)}


def _pair(name, y_dim, h_dim=H, seed=0):
    jm = getattr(jmodels, name)(x_dim=X, y_dim=y_dim, z_dim=Z, h_dim=h_dim)
    rngs = {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1)}
    args = (jnp.ones((4, X)),) if name == "EncoderClassifier" else (
        jnp.ones((4, X)), jnp.ones((4, y_dim)))
    params = jmodels.init_params(jm, rngs, *args)
    tm = getattr(tmodels, name)(X, y_dim, Z, h_dim)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module", params=[(f, y) for f in FAMILIES for y in (1, 513)],
                ids=lambda p: f"{p[0]}-y{p[1]}")
def pair(request):
    name, y_dim = request.param
    return (name, y_dim, *_pair(name, y_dim))


def _np(a):
    return np.asarray(a, np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-6)


def test_state_dict_names_match_export(pair):
    name, y_dim, _, params, tm = pair
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params))
    ref = export_torch_state_dict(params)
    assert set(sd) == set(ref) == set(tm.state_dict())
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k].numpy())
    prefix = "enc_dec_clf." if name == "DisentangledVAE" else ""
    assert f"{prefix}encoder.hidden.0.weight" in sd
    if name != "EncoderClassifier":
        assert sd[f"{prefix}decoder.hidden.0.weight"].shape == (H[-1], Z + y_dim)
    if name in METHODS:
        assert f"{prefix}classifier.output_layer.bias" in sd
    if name in ("CVAE_v4", "DisentangledVAE"):
        assert sd["auxiliary.hidden.0.weight"].shape == (H[0], Z)


def test_methods_match_flax(pair):
    name, y_dim, jm, params, tm = pair
    rng = np.random.default_rng(1)
    x = np.abs(rng.standard_normal((7, X))).astype(np.float32)
    y = rng.uniform(size=(7, y_dim)).astype(np.float32)
    z = rng.standard_normal((7, Z)).astype(np.float32)
    enc_in = np.concatenate([x, y], -1) if name == "CVAE" else x
    with torch.no_grad():
        # EncoderClassifier's forward is its encoder; it has no encode method
        method = "__call__" if name == "EncoderClassifier" else "encode"
        tz, tmu, tlv = (a.numpy() for a in getattr(tm, method)(torch.from_numpy(enc_in),
                                                                sample=False))
        jz, jmu, jlv = jm.apply(params, jnp.asarray(enc_in), method=method, sample=False)
        np.testing.assert_array_equal(tz, tmu)
        _close(tmu, jmu)
        _close(tlv, jlv)
        if name != "EncoderClassifier":
            zy = np.concatenate([z, y], -1)
            _close(tm.decode(torch.from_numpy(zy)).numpy(),
                   jm.apply(params, jnp.asarray(zy), method="decode"))
            tout = tm(torch.from_numpy(x), torch.from_numpy(y), sample=False)
            jout = jm.apply(params, jnp.asarray(x), jnp.asarray(y), sample=False)
            assert len(tout) == len(jout) == (4 if name in ("CVAE_v4", "DisentangledVAE") else 3)
            for a, b in zip(tout, jout):
                _close(a.numpy(), b)
        for method in METHODS.get(name, ()):
            arg = z if method == "classify_from_z" else x
            got = getattr(tm, method)(torch.from_numpy(arg)).numpy()
            assert got.shape == (7, y_dim)
            _close(got, jm.apply(params, jnp.asarray(arg), method=method))


def test_sampled_encode_takes_eps_or_generator():
    tm = tmodels.DisentangledVAE(X, 1, Z, H)
    x = torch.rand((5, X))
    eps = torch.randn((5, Z))
    z, mu, lv = tm.encode(x, eps=eps)
    torch.testing.assert_close(z, mu + torch.exp(0.5 * lv) * eps)
    a = tm(x, torch.ones((5, 1)), generator=torch.Generator().manual_seed(2))[1]
    b = tm(x, torch.ones((5, 1)), generator=torch.Generator().manual_seed(2))[1]
    assert torch.equal(a, b)


@pytest.mark.parametrize("y_dim", [1, 513])
def test_classifier_blocks_match_flax(y_dim):
    x = np.random.default_rng(2).standard_normal((6, X)).astype(np.float32)
    for jcls, tcls in ((jmodels.Classifier, tmodels.Classifier),
                       (jmodels.Classifier2Classes, tmodels.Classifier2Classes)):
        jc = jcls(H, y_dim)
        params = jc.init(jax.random.PRNGKey(3), jnp.ones((2, X)))
        tc = tcls(X, H, y_dim)
        tc.load_state_dict(state_dict_from_jax(params), strict=True)
        assert {"hidden.0.weight", "hidden.1.bias", "output_layer.weight"} <= set(tc.state_dict())
        want = np.asarray(jc.apply(params, jnp.asarray(x)))
        with torch.no_grad():
            got = tc(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == ((6, y_dim) if tcls is tmodels.Classifier
                                           else (6, 2, y_dim))
        _close(got, want)
    # batch_norm=True (ROADMAP A16) adds bn.{i} beside hidden.{i}; its
    # numbers are held against Flax in test_torch_port_depth.py
    bn = tmodels.Classifier(X, H, y_dim, batch_norm=True)
    assert {f"bn.{i}.{k}" for i in range(len(H))
            for k in ("weight", "bias", "running_mean", "running_var")} <= set(bn.state_dict())


def test_reference_aliases():
    assert tmodels.DeepGenerativeModel is tmodels.CVAE
    assert tmodels.DeepGenerativeModel_v2 is tmodels.CVAE_v2
    assert tmodels.DeepGenerativeModel_v3 is tmodels.CVAE_v3
    assert tmodels.DeepGenerativeModel_v4 is tmodels.CVAE_v4
    assert tmodels.DeepGenerativeModel_v5 is tmodels.DisentangledVAE
    assert tmodels.Encoder_Classifier is tmodels.EncoderClassifier
    assert tmodels.VariationalAutoencoder is tmodels.VAE


@pytest.mark.parametrize("name", ["CVAE", "DisentangledVAE", "EncoderClassifier"])
def test_extract_decoder_mlp_finds_each_familys_decoder(name):
    _, params, tm = _pair(name, 513)
    pm = extract_decoder_mlp(tm, Z)
    if name == "EncoderClassifier":
        assert pm is None and jax_extract(params, Z) is None
        return
    for a, b in zip(mats_tensors(pm), mats_tensors(mats_from_jax(jax_extract(params, Z)))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert pm.w1y.shape == (513, H[-1])


@pytest.mark.parametrize("labels", ["ibm", "soft"])
def test_bf16_folded_decoder_at_ibm_width_matches_jax(labels):
    """y_dim 513 at the published widths: the widest fold of the chain."""
    _, params, _ = _pair("CVAE_v2", 513, h_dim=(128, 128), seed=4)
    jmats = jax_extract(params, Z)
    rows = 512
    rng = np.random.default_rng(5)
    z = rng.standard_normal((rows, Z)).astype(np.float32)
    y = rng.uniform(size=(rows, 513)).astype(np.float32)
    if labels == "ibm":
        y = (y > 0.5).astype(np.float32)
    want = np.asarray(make_mlp_decoder(jmats, fast=True)(jnp.asarray(np.concatenate([z, y], -1))))
    tmats = fold_conditioning(mats_from_jax(jmats), torch.from_numpy(y), fast_decoder=True)
    assert tmats.w1y is None and tmats.b1.shape == (rows, 128)
    got = decoder_reference(tmats, tmats.b1, fast_decoder=True)(torch.from_numpy(z)).numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() < 5e-3 and (rel < 1e-5).mean() >= 0.99, (rel.max(), (rel < 1e-5).mean())
