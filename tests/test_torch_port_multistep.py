"""Port parity: ``steps_per_dispatch = K > 1`` (``train.steps.MultiStep``
and the loop's buffered dispatch) on the CPU, where the K steps run one
after another: the plain version of the CUDA graph.

* Against JAX: the port's K-step gets the per-step noise that JAX's K-step
  (``make_multi_train_step``, ``make_gather_train_steps``,
  ``index_fed_steps`` and ``multi=True`` of the semisup and adversarial
  steps) draws from ``split(key, K)``, recovered from the JAX encoder's
  sample as in ``test_torch_port_train_cond.py``. After two dispatches
  every parameter agrees to 2e-6 absolute, and each dispatch's per-step
  mean metrics to rtol 1e-5. Every family sees rows of unit scale
  (``|N(0, 1)| + 0.1``), from seed 4. A first-layer weight whose first
  gradient lies within f32 rounding of zero moves by Adam's
  ``g / (|g| + 1e-8)``, a fraction of lr, one way in JAX and another in
  the port: on power-like rows (3.3e-5 after one step) and on the unit
  rows of seed 3 (M1, one weight, 6.2e-5), the single steps differ as much
  as the K-steps do (measured), so such rows test the step, not the
  dispatch.
* Against K = 1: ``fit_vae``, ``fit_semisup`` and ``fit_adversarial`` at
  K = 4 (5 full batches of 128 and a ragged one of 60 per epoch: a
  dispatch of 4, then one batch, then the ragged one alone) give K = 1's
  checkpoints bitwise and the same epoch log lines, host-fed and
  device-resident, and so does a run that resumes with another K.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.models as jmodels
import dvae_tpu.train.steps as js
import dvae_tpu_torch.models as tmodels
from dvae_tpu_torch.data.datasets import FrameDataset
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.train import steps as ts
from dvae_tpu_torch.train.loop import LoopConfig, fit_adversarial, fit_semisup, fit_vae
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

F, Z, H, B, K, LR = 513, 16, (32, 32), 32, 4, 1e-4


def _unit_rows(n, seed):
    return (np.abs(np.random.default_rng(seed).standard_normal((n, F))) + 0.1).astype(
        np.float32)


def _labels(n, y_dim, seed):
    return (np.random.default_rng(seed).uniform(size=(n, y_dim)) > 0.5).astype(np.float32)


def _pair(kind):
    """(JAX model, its weights, the port's model with them, y_dim, rows,
    encoder input of (x, y))."""
    name, y_dim = {"m1": ("VAE", 0), "m2": ("CVAE", 513), "semisup": ("CVAE_v3", 1),
                   "adversarial": ("DisentangledVAE", 1)}[kind]
    dims = dict(x_dim=F, z_dim=Z, h_dim=H) | ({"y_dim": y_dim} if y_dim else {})
    jm = getattr(jmodels, name)(**dims)
    args = (jnp.ones((4, F)),) + ((jnp.ones((4, y_dim)),) if y_dim else ())
    params = jmodels.init_params(
        jm, {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, *args)
    tm = getattr(tmodels, name)(**dims)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    rows = _unit_rows
    enc_in = (lambda x, y: np.concatenate([x, y], -1)) if kind == "m2" else (lambda x, y: x)
    return jm, params, tm, y_dim, rows, enc_in


def _jax_and_port_steps(kind, jm, params, tm, gather):
    """(JAX state, JAX K-step ``(state, xs, ys, key)``, port step, port
    optimizers, data setter) for one step kind; ``gather`` feeds both
    index batches into a device-resident split."""
    tx = js.adam(LR)
    if kind == "adversarial":
        tx_a = js.adam(LR)
        state = js.init_adversarial_state(params, tx, tx_a)
        jstep = js.make_adversarial_step(jm, tx, tx_a, 0.0, 10.0, 1.0, layout="v5")
        jmulti = js.make_adversarial_step(jm, tx, tx_a, 0.0, 10.0, 1.0, layout="v5", multi=True)
        opts = ts.init_adversarial_state(tm, LR)
        tstep = ts.make_adversarial_step(tm, *opts, 0.0, 10.0, 1.0, keep_grads=True)
    else:
        state = js.init_train_state(jm, params, tx)
        opts = (ts.adam(tm.parameters(), LR),)
        if kind == "semisup":
            jstep = js.make_semisup_step(jm, tx, "uloss", 10.0, "soft")
            jmulti = js.make_semisup_step(jm, tx, "uloss", 10.0, "soft", multi=True)
            tstep = ts.make_semisup_step(tm, opts[0], "uloss", 10.0, "soft", keep_grads=True)
        else:
            cond = kind == "m2"
            jmulti = js.make_multi_train_step(jm, tx, cond)
            if not cond:
                m = jmulti
                jmulti = lambda st, xs, ys, key: m(st, xs, key)  # noqa: E731
            tstep = ts.make_train_step(tm, opts[0], cond, keep_grads=True)

    def jax_k_step(data, labels):
        if not gather:
            return jmulti
        if kind in ("m1", "m2"):
            return js.make_gather_train_steps(jm, tx, kind == "m2", data, labels)[1]
        return js.index_fed_steps(jstep, jmulti, None, data, labels, None, None)[1]

    return state, jax_k_step, tstep, opts


@pytest.mark.parametrize("gather", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("kind", ["m1", "m2", "semisup", "adversarial"])
def test_multistep_matches_jax_k_step(kind, gather):
    jm, params, tm, y_dim, rows, enc_in = _pair(kind)
    n = 2 * K * B
    x_all, y_all = rows(n, 4), (_labels(n, y_dim, 4) if y_dim else None)
    state, jax_k_step, tstep, opts = _jax_and_port_steps(kind, jm, params, tm, gather)
    jdata = jnp.asarray(x_all), None if y_all is None else jnp.asarray(y_all)
    jmulti = jax_k_step(*jdata)
    tdata = torch.from_numpy(x_all), None if y_all is None else torch.from_numpy(y_all)
    multi = ts.MultiStep(tstep, opts, tdata if gather else None)
    perm = np.random.default_rng(5).permutation(n).reshape(2, K, B)
    for d in range(2):
        idx = perm[d]
        xs, ys = x_all[idx], None if y_all is None else y_all[idx]
        key = jax.random.PRNGKey(100 + d)
        eps = torch.stack([_noise(jm, params, enc_in(xs[k], None if ys is None else ys[k]), kk)
                           for k, kk in enumerate(jax.random.split(key, K))])
        if gather:
            state, want = jmulti(state, jnp.asarray(idx, jnp.int32), None, key)
            got = multi(torch.from_numpy(idx), None, sample_eps=eps)
        else:
            state, want = jmulti(state, jnp.asarray(xs), None if ys is None else jnp.asarray(ys),
                                 key)
            got = multi(torch.from_numpy(xs), None if ys is None else torch.from_numpy(ys),
                        sample_eps=eps)
        assert got.shape == (K, len(multi.names))
        mean = dict(zip(multi.names, got.double().mean(0).tolist()))
        assert set(mean) == set(want), (set(mean), set(want))
        for k in want:
            np.testing.assert_allclose(mean[k], float(want[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"dispatch {d}: {k}")
    want = state_dict_from_jax(jax.device_get(state.params))
    for name, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0, atol=2e-6,
                                   err_msg=name)


def _noise(jm, params, enc_in, key):
    """The noise the JAX model draws with ``key`` (it depends on neither the
    weights nor the encoder's input)."""
    z, mu, lv = (np.asarray(a, np.float64) for a in jm.apply(
        params, jnp.asarray(enc_in), method="encode", rngs={"sample": key}))
    return torch.from_numpy(((z - mu) * np.exp(-0.5 * lv)).astype(np.float32))


def test_multistep_rows_come_from_the_split_by_index():
    """Fed indices, the K-step gathers the rows (and labels) that a host
    stack of the same batches holds, and runs the same K steps."""
    runs = []
    for gather in (False, True):
        torch.manual_seed(0)
        tm = tmodels.CVAE(F, 1, Z, H)
        opt = ts.adam(tm.parameters(), LR)
        x_all, y_all = torch.from_numpy(_unit_rows(96, 1)), torch.from_numpy(_labels(96, 1, 2))
        multi = ts.MultiStep(ts.make_train_step(tm, opt, True, keep_grads=True), [opt],
                             (x_all, y_all) if gather else None)
        idx = torch.arange(96).flip(0).reshape(3, 32)
        gen = torch.Generator().manual_seed(3)
        out = multi(idx, None, generator=gen) if gather else \
            multi(x_all[idx], y_all[idx], generator=gen)
        runs.append((out, {k: v.clone() for k, v in tm.state_dict().items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())


# ---------------------------------------------------------------------------
# the fitters at K = 4 against K = 1
# ---------------------------------------------------------------------------

N_TRAIN, N_VALID = 700, 200


def _datasets():
    xt, xv = _unit_rows(N_TRAIN, 1), _unit_rows(N_VALID, 2)
    label = lambda x: (x[:, :40].mean(1, keepdims=True) > 0.9).astype(np.float32)  # noqa: E731
    return (FrameDataset.from_arrays(xt, label(xt), xt.mean(0)[:, None], xt.std(0)[:, None]),
            FrameDataset.from_arrays(xv, label(xv)))


FITTERS = {
    "m1": lambda d, cfg: fit_vae(tmodels.VAE(F, Z, H), *_datasets(), d, "M1", cfg=cfg,
                                 device="cpu"),
    "m2v3": lambda d, cfg: fit_semisup(tmodels.CVAE_v3(F, 1, Z, H), *_datasets(), d, "M2",
                                       "uloss", 10.0, cfg=cfg, device="cpu"),
    "m2info": lambda d, cfg: fit_adversarial(tmodels.DisentangledVAE(F, 1, Z, H), *_datasets(),
                                             d, "M2", 0.0, 10.0, 1.0, cfg=cfg, device="cpu"),
}


def _checkpoints(d):
    return {p.name: torch.load(p, weights_only=True) for p in sorted(d.glob("*.pt"))}


def _epoch_lines(d):
    """output_epoch.log without the wall-clock time of each epoch."""
    return [ln for ln in (d / "output_epoch.log").read_text().splitlines()
            if not ln.startswith("Epoch: ")]


def _same(a, b, what):
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


@pytest.mark.parametrize("device_data", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("name", sorted(FITTERS))
def test_fit_k4_gives_k1_checkpoints_bitwise(tmp_path, name, device_data):
    cfg = LoopConfig(batch_size=128, end_epoch=3, seed=2, log_interval=2,
                     device_data=device_data)
    _, h1 = FITTERS[name](tmp_path / "k1", cfg)
    _, h4 = FITTERS[name](tmp_path / "k4", LoopConfig(**{**cfg.__dict__,
                                                         "steps_per_dispatch": K}))
    _same(_checkpoints(tmp_path / "k1"), _checkpoints(tmp_path / "k4"), "checkpoints")
    assert [h["valid"] for h in h1] == [h["valid"] for h in h4]
    assert _epoch_lines(tmp_path / "k1") == _epoch_lines(tmp_path / "k4")
    # a dispatch logs the per-step means of its batches at its first index,
    # when that index's batch is due (i % log_interval < steps covered)
    batch_log = (tmp_path / "k4" / "output_batch.log").read_text().splitlines()
    assert [ln.split("]")[0].split("[")[1] for ln in batch_log] == ["0/6", "4/6"] * 2


@pytest.mark.parametrize("name", sorted(FITTERS))
def test_resume_with_another_k_is_bitwise(tmp_path, name):
    """Epochs 1-2 at K = 1, then epoch 3 resumed at K = 4 (and the other
    way round), give the uninterrupted K = 1 run's last checkpoint."""
    cfg = LoopConfig(batch_size=128, end_epoch=4, seed=5)
    FITTERS[name](tmp_path / "full", cfg)
    want = {k: v for k, v in _checkpoints(tmp_path / "full").items() if "_epoch_003_" in k}
    for first, then in ((1, K), (K, 1)):
        d = tmp_path / f"{first}-{then}"
        FITTERS[name](d, LoopConfig(**{**cfg.__dict__, "end_epoch": 3,
                                       "steps_per_dispatch": first}))
        FITTERS[name](d, LoopConfig(**{**cfg.__dict__, "start_epoch": 3,
                                       "steps_per_dispatch": then}))
        got = {k: v for k, v in _checkpoints(d).items() if "_epoch_003_" in k}
        _same(want, got, f"K {first} then {then}")
