"""Port parity: losses, the M1 ELBO step, ``fit_vae`` and its checkpoints.

Inputs are made with numpy from a seed and fed to both packages. Losses
agree to rtol 1e-5 (the same f32 formulas, reduced in another order). The
ELBO steps start from the same weights and get the same batches and the
same reparameterization noise; after 1 and 5 Adam steps at lr 1e-4 every
parameter agrees to 2e-6 absolute (2% of one step; gradients agree to ~1e-6
relative, and Adam's first steps move each weight by about lr whatever its
gradient's size). On the port's own side, a resumed run and the
device-resident data path reproduce the uninterrupted host-fed run bitwise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dvae_tpu.data.datasets as jdatasets
import dvae_tpu.models.losses as jl
import dvae_tpu_torch.data.datasets as tdatasets
import dvae_tpu_torch.models.losses as tl
from dvae_tpu.models import VAE as JaxVAE
from dvae_tpu.train import checkpoint as jckpt
from dvae_tpu.train.steps import adam as jadam
from dvae_tpu_torch.data.datasets import FrameDataset
from dvae_tpu_torch.models import CVAE, VAE
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.train import checkpoint as tckpt
from dvae_tpu_torch.train import loop as tloop
from dvae_tpu_torch.train.loop import LoopConfig, fit_vae
from dvae_tpu_torch.train.steps import adam, make_eval_step, make_train_step
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

H = (32, 32)


def _rng_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b, f = 16, 7
    r = rng.uniform(0.0, 1.0, (b, f)).astype(np.float32)
    r[0, :3] = [0.0, 1.0, 1.0 - 1e-9]  # saturated predictions: the _SAT clip
    return {
        "r": r, "r2": rng.uniform(0.0, 1.0, (b, f)).astype(np.float32),
        "y": (rng.uniform(size=(b, f)) > 0.5).astype(np.float32),
        "x": rng.exponential(1.0, (b, f)).astype(np.float32) + 1e-3,
        "v": rng.exponential(1.0, (b, f)).astype(np.float32) + 1e-3,
        "mu": rng.standard_normal((b, 4)).astype(np.float32),
        "lv": rng.standard_normal((b, 4)).astype(np.float32),
        "ys": rng.uniform(0.0, 1.0, (b, 2)).astype(np.float32),
        "c1": (rng.standard_normal((b, f)) + 1j * rng.standard_normal((b, f))).astype(np.complex64),
        "c2": (rng.standard_normal((b, f)) + 1j * rng.standard_normal((b, f))).astype(np.complex64),
        "logits": 5 * rng.standard_normal((b, f)).astype(np.float32),
    }


LOSS_CASES = {
    "binary_cross_entropy": ("r", "y"),
    "binary_cross_entropy_v2": ("r",),
    "binary_cross_entropy_v3": ("r",),
    "binary_cross_entropy_2classes": ("r", "r2", "y"),
    "itakura_saito_divergence": ("v", "x"),
    "ikatura_saito_divergence": ("v", "x"),
    "kl_gaussian_standard": ("mu", "lv"),
    "elbo": ("x", "v", "mu", "lv"),
    "L_loss": ("x", "v", "mu", "lv"),
    "U_loss": ("x", "v", "mu", "lv", "ys"),
    "mean_square_error_signal": ("x", "r", "r2"),
    "mean_square_error_mask": ("r", "r2"),
    "magnitude_spectrum_approximation_loss": ("c1", "c2", "r"),
    "log_standard_gaussian": ("mu",),
    "log_gaussian": ("x", "mu", "lv"),
    "log_standard_categorical": ("r",),
    "log_sum_exp": ("logits",),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name):
    inp = _rng_inputs()
    if name in ("log_gaussian",):
        inp["x"] = inp["x"][:, :4]
    args = [inp[k] for k in LOSS_CASES[name]]
    want = getattr(jl, name)(*map(jnp.asarray, args))
    got = getattr(tl, name)(*map(torch.from_numpy, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_f1_and_label_helpers_match_jax():
    inp = _rng_inputs(1)
    hard, y = (inp["r"] > 0.5).astype(np.float32), inp["y"]
    mask = (inp["r2"] > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jl.f1_loss(jnp.asarray(hard), jnp.asarray(y),
                          mask=None if m is None else jnp.asarray(m))
        got = tl.f1_loss(torch.from_numpy(hard), torch.from_numpy(y),
                         mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                                   rtol=1e-6)
    np.testing.assert_array_equal(tl.onehot(2, 5).numpy(), np.asarray(jl.onehot(2, 5)))
    np.testing.assert_array_equal(tl.enumerate_discrete(3, 2).numpy(),
                                  np.asarray(jl.enumerate_discrete(3, 2)))
    np.testing.assert_array_equal(tl.prior_categorical(3, 4).numpy(),
                                  np.asarray(jl.prior_categorical(3, 4)))


def _frames(n, seed):
    """Power-spectrogram-like positive rows."""
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.standard_normal((1, 513)))
    return (rng.exponential(1.0, (n, 513)) * scale + 1e-4).astype(np.float32)


def _jax_model(seed=0):
    jm = JaxVAE(x_dim=513, z_dim=16, h_dim=H)
    params = jm.init({"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1)},
                     jnp.ones((4, 513)))
    return jm, params


def _jax_elbo_steps(jm, params, xs, epss, lr, norm=None):
    """The JAX reference: VAE.apply (encode, reparameterize with the given
    eps, decode), losses.elbo against raw x, steps.adam."""
    mean, std = (None, None) if norm is None else (jnp.asarray(a).reshape(-1) for a in norm)

    def loss_fn(p, x, eps):
        x_in = x if norm is None else (x - mean) / (std + 1e-8)
        _, mu, lv = jm.apply(p, x_in, method="encode", sample=False)
        r = jm.apply(p, mu + jnp.exp(0.5 * lv) * eps, method="decode")
        return jl.elbo(x, r, mu, lv, 1e-8)[0]

    tx = jadam(lr)
    opt_state = tx.init(params)
    totals = []
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    for x, eps in zip(xs, epss):
        total, grads = grad_fn(params, jnp.asarray(x), jnp.asarray(eps))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        totals.append(float(total))
    return params, totals


@pytest.mark.parametrize("std_norm", [False, True], ids=["nonorm", "norm"])
def test_elbo_steps_match_jax(std_norm):
    jm, params = _jax_model()
    rng = np.random.default_rng(3)
    xs = [_frames(32, 10 + k) for k in range(5)]
    epss = [rng.standard_normal((32, 16)).astype(np.float32) for _ in range(5)]
    norm = None
    if std_norm:
        allx = np.concatenate(xs)
        norm = (allx.mean(0)[:, None], allx.std(0)[:, None])

    tm = VAE(513, 16, H)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    opt = adam(tm.parameters(), 1e-4)
    step = make_train_step(tm, opt, norm=norm)
    got_totals = []
    for k, (x, eps) in enumerate(zip(xs, epss)):
        m = step(torch.from_numpy(x), sample_eps=torch.from_numpy(eps))
        got_totals.append(float(m["elbo"]))
        if k in (0, 4):
            want, want_totals = _jax_elbo_steps(jm, params, xs[:k + 1], epss[:k + 1], 1e-4, norm)
            np.testing.assert_allclose(got_totals, want_totals, rtol=1e-5)
            sd = state_dict_from_jax(want)
            for name, v in tm.state_dict().items():
                np.testing.assert_allclose(v.numpy(), sd[name].numpy(), rtol=0, atol=2e-6,
                                           err_msg=f"{name} after {k + 1} steps")
    # the parameters did move, by about lr per step
    moved = max(float((v - state_dict_from_jax(params)[n]).abs().max())
                for n, v in tm.state_dict().items())
    assert 1e-4 < moved < 1e-3
    # the eval step is the same ELBO without an update
    evaluate = make_eval_step(tm, norm=norm)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    e = evaluate(torch.from_numpy(xs[0]), sample_eps=torch.from_numpy(epss[0]))
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())
    assert np.isfinite(float(e["elbo"]))


def test_conditional_raises(tmp_path):
    """The conditional (M2) step trains and raises only without labels;
    what stays unported (K steps per dispatch, a mesh) still raises, naming
    its ROADMAP item. Parity with JAX: tests/test_torch_port_train_cond.py."""
    tm = CVAE(513, 1, 16, H)
    step = make_train_step(tm, adam(tm.parameters()), conditional=True)
    x = torch.from_numpy(_frames(32, 5))
    y = torch.from_numpy((np.arange(32) % 2).astype(np.float32)[:, None])
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    m = step(x, y, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["elbo"]))
    assert all(not torch.equal(before[k], v) for k, v in tm.state_dict().items())
    with pytest.raises(ValueError, match="labels y"):
        step(x)
    train = FrameDataset.from_arrays(_frames(64, 1), y.numpy().repeat(2, 0))
    for cfg, kw, item in ((LoopConfig(end_epoch=2, steps_per_dispatch=4), {}, "A12.5"),
                          (LoopConfig(end_epoch=2), {"mesh": object()}, "A14")):
        with pytest.raises(NotImplementedError, match=item):
            fit_vae(CVAE(513, 1, 16, H), train, train, tmp_path, "M2", conditional=True,
                    cfg=cfg, device="cpu", **kw)


def test_frame_dataset_h5_matches_jax(tmp_path):
    """The consolidated frame h5 layout of build_frame_dataset ((F, N) splits, (F, 1) train
    statistics) reads into the same rows, batches and statistics."""
    import h5py

    rng = np.random.default_rng(6)
    path = tmp_path / "frames.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("X_train", data=_frames(300, 3).T)
        f.create_dataset("Y_train", data=(rng.uniform(size=(1, 300)) > 0.5).astype(np.float32))
        f.create_dataset("X_train_mean", data=rng.uniform(size=(513, 1)).astype(np.float32))
        f.create_dataset("X_train_std", data=rng.uniform(size=(513, 1)).astype(np.float32))
    jds, tds = jdatasets.FrameDataset(path, "train"), FrameDataset(path, "train")
    assert len(tds) == len(jds) == 300 and tds.x_dim == 513
    for a, b in zip(tds.arrays, jds.arrays):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tds.mean_std, jds.mean_std):
        np.testing.assert_array_equal(a, b)
    got = list(tds.batches(64, np.random.default_rng((1, 2)), drop_last=True))
    want = list(jds.batches(64, np.random.default_rng((1, 2)), drop_last=True))
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    with pytest.raises(ValueError, match="no train statistics"):
        FrameDataset.from_arrays(np.zeros((4, 513), np.float32)).mean_std


def _datasets(n_train=700, n_valid=200):
    xt, xv = _frames(n_train, 1), _frames(n_valid, 2)
    mean, std = xt.mean(0)[:, None], xt.std(0)[:, None]
    return FrameDataset.from_arrays(xt, None, mean, std), FrameDataset.from_arrays(xv)


def _fit(tmp, cfg, init=None, **kw):
    tm = VAE(513, 16, H)
    train, valid = _datasets()
    best, hist = fit_vae(tm, train, valid, tmp, "M1", cfg=cfg, init_state_dict=init,
                         device="cpu", **kw)
    return tm, best, hist


def test_fit_vae_shuffle_orders_match_jax(monkeypatch, tmp_path):
    """fit_vae walks each epoch's rows in the order the JAX loop uses:
    index_batches over np.random.default_rng((seed, epoch)), host-fed and
    device-resident alike."""
    seen, index_batches = [], tdatasets.index_batches

    def recording(n, batch_size, rng=None, drop_last=False):
        for sel in index_batches(n, batch_size, rng, drop_last):
            seen.append(sel.copy())
            yield sel

    monkeypatch.setattr(tdatasets, "index_batches", recording)
    monkeypatch.setattr(tloop, "index_batches", recording)
    cfg = LoopConfig(batch_size=128, end_epoch=3, seed=4)
    for device_data in (False, True):
        seen.clear()
        _fit(tmp_path / str(device_data), LoopConfig(**{**cfg.__dict__, "device_data": device_data}))
        want = []
        for epoch in (1, 2):
            want += list(jdatasets.index_batches(700, 128, np.random.default_rng((4, epoch))))
            want += list(jdatasets.index_batches(200, 128, None))
        assert len(seen) == len(want)
        for a, b in zip(seen, want):
            np.testing.assert_array_equal(a, b)


def test_fit_vae_resume_and_device_data_are_bitwise(tmp_path):
    cfg = LoopConfig(batch_size=128, end_epoch=4, seed=2, log_interval=2)
    full, best, hist = _fit(tmp_path / "full", cfg)
    assert [h["epoch"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["train"]["elbo"]) and np.isfinite(h["valid"]["elbo"])
               for h in hist)
    # the best weights are those of the epoch with the lowest validation ELBO
    vl = [h["valid"]["elbo"] for h in hist]
    best_file = tckpt.best_checkpoint(tmp_path / "full", "M1")
    assert best_file.name.startswith(f"M1_epoch_{1 + int(np.argmin(vl)):03d}_vloss_")
    loaded = torch.load(best_file, weights_only=True)
    assert all(torch.equal(loaded[k], best[k]) for k in best)

    part_dir = tmp_path / "part"
    _fit(part_dir, LoopConfig(**{**cfg.__dict__, "end_epoch": 3}))
    resumed, _, hist_r = _fit(part_dir, LoopConfig(**{**cfg.__dict__, "start_epoch": 3}))
    assert [h["epoch"] for h in hist_r] == [3]
    for k, v in full.state_dict().items():
        assert torch.equal(v, resumed.state_dict()[k]), k
    assert hist_r[0] == hist[2]
    # the resumed run appends to the epoch log and writes the same checkpoint names
    log = (part_dir / "output_epoch.log").read_text()
    assert log.count("Epoch: ") == 3 and "[Validation]" in log
    names = lambda d: sorted(p.name for p in d.glob("M1_epoch_*"))  # noqa: E731
    assert names(part_dir) == names(tmp_path / "full")
    assert len(tckpt.checkpoints(part_dir)) == 3  # .opt.pt files are not weights
    meta = json.loads((part_dir / (best_file.stem + ".json")).read_text())
    assert set(meta) == {"epoch", "elbo", "recon", "kl"}

    dd, _, hist_d = _fit(tmp_path / "dd", LoopConfig(**{**cfg.__dict__, "device_data": True}))
    assert hist_d == hist
    for k, v in full.state_dict().items():
        assert torch.equal(v, dd.state_dict()[k]), k


def test_fit_vae_std_norm_and_unported_options(tmp_path):
    _, _, hist = _fit(tmp_path, LoopConfig(batch_size=256, end_epoch=2, std_norm=True))
    assert np.isfinite(hist[0]["valid"]["elbo"])
    with pytest.raises(ValueError, match="needs a dataset with labels"):
        _fit(tmp_path, LoopConfig(end_epoch=2), conditional=True)
    with pytest.raises(NotImplementedError, match="A14"):
        _fit(tmp_path, LoopConfig(end_epoch=2), mesh=object())
    with pytest.raises(NotImplementedError, match="CUDA graph"):
        _fit(tmp_path, LoopConfig(end_epoch=2, steps_per_dispatch=4))
    with pytest.raises(FileNotFoundError, match="no epoch-4 checkpoint"):
        _fit(tmp_path / "empty", LoopConfig(start_epoch=5, end_epoch=6))


def test_port_checkpoint_loads_into_jax_vae(tmp_path):
    """A .pt written by the port is a bare state_dict in the reference's
    names: dvae_tpu.train.checkpoint.load_checkpoint reads it into a JAX VAE
    template, and the decoder agrees with the port's (rtol 1e-5)."""
    jm, template = _jax_model(7)
    tm, _, _ = _fit(tmp_path, LoopConfig(batch_size=256, end_epoch=2),
                    init=state_dict_from_jax(template))
    path = tckpt.best_checkpoint(tmp_path)
    jparams = jckpt.load_checkpoint(path, template)
    tckpt.load_checkpoint(path, tm)
    z = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    want = np.asarray(jm.apply(jparams, jnp.asarray(z), method="decode"))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
