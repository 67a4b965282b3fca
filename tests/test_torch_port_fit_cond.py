"""Port: the labelled fitters (``fit_vae(conditional=True)``,
``fit_semisup``, ``fit_adversarial``), their checkpoints and
``partial_load``.

On the port's own side a run resumed at ``start_epoch`` and a run on
device-resident data (rows and labels gathered by the same index batches)
reproduce the uninterrupted host-fed run bitwise: weights, history and,
for the adversarial game, both optimizers' states. Each epoch walks its
rows in the JAX loop's order. ``partial_load`` of a port ``.pt`` gives the
weights the JAX package's ``partial_load`` gives from the same file. The
step math itself is held against JAX in ``test_torch_port_train_cond.py``.
"""

import jax
import numpy as np
import pytest
import torch

import dvae_tpu.data.datasets as jdatasets
import dvae_tpu_torch.data.datasets as tdatasets
from dvae_tpu.models import DisentangledVAE as JaxDisentangledVAE
from dvae_tpu.models import init_params
from dvae_tpu.train import checkpoint as jckpt
from dvae_tpu_torch.data.datasets import FrameDataset
from dvae_tpu_torch.models import CVAE, CVAE_v3, DisentangledVAE
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.parallel import Mesh
from dvae_tpu_torch.train import checkpoint as tckpt
from dvae_tpu_torch.train import loop as tloop
from dvae_tpu_torch.train.loop import LoopConfig, fit_adversarial, fit_semisup, fit_vae
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

F, Z, H = 513, 16, (32, 32)
N_TRAIN, N_VALID = 700, 200


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((n, F))) + 0.1).astype(np.float32)


def _datasets():
    xt, xv = _rows(N_TRAIN, 1), _rows(N_VALID, 2)
    label = lambda x: (x[:, :40].mean(1, keepdims=True) > 0.9).astype(np.float32)  # noqa: E731
    mean, std = xt.mean(0)[:, None], xt.std(0)[:, None]
    return (FrameDataset.from_arrays(xt, label(xt), mean, std),
            FrameDataset.from_arrays(xv, label(xv)))


FITTERS = {
    "m2": (lambda: CVAE(F, 1, Z, H), "M2", "elbo",
           lambda m, tr, va, d, p, cfg, **kw: fit_vae(m, tr, va, d, p, conditional=True,
                                                      cfg=cfg, device="cpu", **kw)),
    "m2v3": (lambda: CVAE_v3(F, 1, Z, H), "M2v3", "loss",
             lambda m, tr, va, d, p, cfg, **kw: fit_semisup(m, tr, va, d, p, "uloss", 10.0,
                                                            cfg=cfg, device="cpu", **kw)),
    "m2info": (lambda: DisentangledVAE(F, 1, Z, H), "M2_info", "enc",
               lambda m, tr, va, d, p, cfg, **kw: fit_adversarial(
                   m, tr, va, d, p, 0.0, 10.0, 1.0, cfg=cfg, device="cpu", **kw)),
}


def _fit(name, model_dir, cfg, **kw):
    make, prefix, _, fit = FITTERS[name]
    model = make()
    train, valid = _datasets()
    best, hist = fit(model, train, valid, model_dir, prefix, cfg, **kw)
    return model, best, hist


def _opt_states(path):
    return torch.load(path.with_name(path.name[:-3] + ".opt.pt"), weights_only=True)


def _same(a, b, what):
    """Nested dicts / lists of tensors and numbers, bitwise."""
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("name", sorted(FITTERS))
def test_labelled_fit_shuffle_orders_match_jax(monkeypatch, tmp_path, name):
    """Each epoch walks its rows (and their labels) in the JAX loop's order,
    index_batches over np.random.default_rng((seed, epoch)), host-fed and
    device-resident alike."""
    seen, index_batches = [], tdatasets.index_batches

    def recording(n, batch_size, rng=None, drop_last=False):
        for sel in index_batches(n, batch_size, rng, drop_last):
            seen.append(sel.copy())
            yield sel

    monkeypatch.setattr(tdatasets, "index_batches", recording)
    monkeypatch.setattr(tloop, "index_batches", recording)
    for device_data in (False, True):
        seen.clear()
        _fit(name, tmp_path / str(device_data),
             LoopConfig(batch_size=128, end_epoch=3, seed=4, device_data=device_data))
        want = []
        for epoch in (1, 2):
            want += list(jdatasets.index_batches(N_TRAIN, 128, np.random.default_rng((4, epoch))))
            want += list(jdatasets.index_batches(N_VALID, 128, None))
        assert len(seen) == len(want)
        for a, b in zip(seen, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(FITTERS))
def test_labelled_fit_resume_and_device_data_are_bitwise(tmp_path, name):
    _, prefix, vloss_key, _ = FITTERS[name]
    cfg = LoopConfig(batch_size=128, end_epoch=4, seed=2, log_interval=2)
    full, best, hist = _fit(name, tmp_path / "full", cfg)
    assert [h["epoch"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(list(h["train"].values()) + list(h["valid"].values())).all()
               for h in hist)
    # checkpoints are named and picked by the fitter's validation metric
    vl = [h["valid"][vloss_key] for h in hist]
    best_file = tckpt.best_checkpoint(tmp_path / "full", prefix)
    assert best_file.name.startswith(f"{prefix}_epoch_{1 + int(np.argmin(vl)):03d}_vloss_")
    loaded = torch.load(best_file, weights_only=True)
    assert all(torch.equal(loaded[k], best[k]) for k in best)
    assert len(tckpt.checkpoints(tmp_path / "full")) == 3

    part_dir = tmp_path / "part"
    _fit(name, part_dir, LoopConfig(**{**cfg.__dict__, "end_epoch": 3}))
    resumed, _, hist_r = _fit(name, part_dir, LoopConfig(**{**cfg.__dict__, "start_epoch": 3}))
    assert hist_r[0] == hist[2]
    for k, v in full.state_dict().items():
        assert torch.equal(v, resumed.state_dict()[k]), k
    last = sorted((tmp_path / "full").glob(f"{prefix}_epoch_003_*.pt"))
    last = [p for p in last if not p.name.endswith(".opt.pt")][0]
    opt_full = _opt_states(last)
    if name == "m2info":
        assert set(opt_full) == {"enc", "aux"}  # both players' Adam states, restored
    _same(opt_full, _opt_states(part_dir / last.name), "optimizer state")

    dd, _, hist_d = _fit(name, tmp_path / "dd", LoopConfig(**{**cfg.__dict__, "device_data": True}))
    assert hist_d == hist
    for k, v in full.state_dict().items():
        assert torch.equal(v, dd.state_dict()[k]), k


def test_labelled_fitters_refuse(tmp_path):
    train, valid = _datasets()
    with pytest.raises(ValueError, match="std_norm"):
        fit_semisup(CVAE_v3(F, 1, Z, H), train, valid, tmp_path, "M2v3", "uloss", 1.0,
                    cfg=LoopConfig(end_epoch=2, std_norm=True), device="cpu")
    unlabelled = FrameDataset.from_arrays(_rows(64, 3))
    for fit in (lambda d: fit_semisup(CVAE_v3(F, 1, Z, H), d, d, tmp_path, "s", "uloss", 1.0,
                                      cfg=LoopConfig(end_epoch=2), device="cpu"),
                lambda d: fit_adversarial(DisentangledVAE(F, 1, Z, H), d, d, tmp_path, "a",
                                          0.0, 1.0, 1.0, cfg=LoopConfig(end_epoch=2),
                                          device="cpu")):
        with pytest.raises(ValueError, match="needs a dataset with labels"):
            fit(unlabelled)
    # a mesh is served (tests/test_torch_port_parallel.py), but one process
    # trains on one device: a mesh over two raises
    for cfg, kw, err, item in (
            (LoopConfig(end_epoch=2, steps_per_dispatch=0), {}, ValueError, "steps_per_dispatch"),
            (LoopConfig(end_epoch=2), {"mesh": Mesh(["cpu", "meta"])}, ValueError,
             "one process per GPU")):
        with pytest.raises(err, match=item):
            fit_adversarial(DisentangledVAE(F, 1, Z, H), train, valid, tmp_path, "a",
                            0.0, 1.0, 1.0, cfg=cfg, device="cpu", **kw)


def test_fit_adversarial_warm_start_frozen_classifier(tmp_path):
    """The pretrain script's pattern: a classifier loaded by partial_load
    into fresh weights, passed as ``init_state_dict``, stays bitwise fixed
    under ``freeze_classifier`` while the rest trains (std_norm on)."""
    donor = DisentangledVAE(F, 1, Z, H)
    torch.nn.init.normal_(donor.enc_dec_clf.classifier.output_layer.weight)
    path = tckpt.save_checkpoint(tmp_path / "donor", "clf_epoch_001_vloss_1.00", donor)
    model = DisentangledVAE(F, 1, Z, H)
    names = tckpt.partial_load(path, model, "enc_dec_clf.classifier")
    assert names and all(n.startswith("enc_dec_clf.classifier.") for n in names)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    train, valid = _datasets()
    best, hist = fit_adversarial(model, train, valid, tmp_path / "run", "M2_info_pre",
                                 1.0, 10.0, 1.0, cfg=LoopConfig(end_epoch=3, std_norm=True),
                                 init_state_dict=init, freeze_classifier=True,
                                 y_cond="soft", enc_adversary="entropy", device="cpu")
    assert set(hist[-1]["train"]) == {"elbo", "recon", "kl", "enc", "classif", "aux_enc", "aux"}
    assert set(hist[-1]["valid"]) == {"elbo", "recon", "kl", "enc", "classif", "aux"}
    for k, v in model.state_dict().items():
        assert torch.equal(v, init[k]) == (".classifier." in k), k
    assert torch.equal(best["enc_dec_clf.classifier.output_layer.weight"],
                       donor.enc_dec_clf.classifier.output_layer.weight)


def test_partial_load_and_extract_submodule_match_jax(tmp_path):
    jm = JaxDisentangledVAE(x_dim=F, y_dim=1, z_dim=Z, h_dim=H)
    x, y = jax.numpy.ones((4, F)), jax.numpy.ones((4, 1))
    p1 = init_params(jm, {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x, y)
    p2 = init_params(jm, {"params": jax.random.PRNGKey(9), "sample": jax.random.PRNGKey(8)}, x, y)
    donor = DisentangledVAE(F, 1, Z, H)
    donor.load_state_dict(state_dict_from_jax(p1))
    path = tckpt.save_checkpoint(tmp_path, "v5_epoch_001_vloss_1.00", donor)

    model = DisentangledVAE(F, 1, Z, H)
    model.load_state_dict(state_dict_from_jax(p2))
    tckpt.partial_load(path, model, "enc_dec_clf.classifier")
    want = state_dict_from_jax(jckpt.partial_load(path, p2, "enc_dec_clf/classifier"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(model.state_dict()["enc_dec_clf.classifier.output_layer.weight"],
                       donor.state_dict()["enc_dec_clf.classifier.output_layer.weight"])
    assert not torch.equal(model.state_dict()["auxiliary.output_layer.weight"],
                           donor.state_dict()["auxiliary.output_layer.weight"])

    sub = tckpt.extract_submodule(model.state_dict(), "enc_dec_clf")
    v3 = CVAE_v3(F, 1, Z, H)
    v3.load_state_dict(sub, strict=True)
    jsub = jckpt.extract_submodule(jckpt.partial_load(path, p2, "enc_dec_clf/classifier"),
                                   "params", "enc_dec_clf")
    assert set(jsub) == {"encoder", "decoder", "classifier"}

    with pytest.raises(KeyError, match="matches no entry"):
        tckpt.partial_load(path, model, "enc_dec_clf/classifier")
    with pytest.raises(KeyError, match="no entry under"):
        tckpt.extract_submodule(model.state_dict(), "nothing")
    wide = tckpt.save_checkpoint(tmp_path, "wide", DisentangledVAE(F, 1, Z, (64, 32)))
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.partial_load(wide, model, "enc_dec_clf.classifier")
