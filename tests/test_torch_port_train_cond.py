"""Port parity: the conditional ELBO, semi-supervised and adversarial
training steps against the JAX package's own step functions.

Both sides start from the same weights (``state_dict_from_jax``) and get
the same numpy batches. The JAX steps draw their noise inside the model
from ``rngs={"sample": key}``; before each JAX step the test applies the
JAX encoder with that key to the step's pre-update weights, recovers the
noise as ``(z - mu) * exp(-0.5 * logvar)`` and hands it to the port's step
as ``sample_eps``. Every metric of every step agrees to rtol 1e-5, and
after 1 and 5 Adam steps at lr 1e-4 every parameter agrees to 2e-6
absolute, as ``test_torch_port_train.py::test_elbo_steps_match_jax`` holds
M1. The eval steps agree to rtol 1e-5 on the trained weights.

The ELBO steps see power-spectrogram-like rows (spanning e^-3..e^3 per
bin). The families with an x -> y relu classifier see rows of unit scale,
``|N(0, 1)| + 0.1``, as the JAX package's own step tests use: on the
power-like rows a first-layer pre-activation of a few hundred can land
within f32 rounding of the relu's kink, which XLA and torch sum in another
order, and Adam's normalized step then moves the weights behind it by
about lr one way or the other (1.7e-4 after two steps, measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvae_tpu.models as jmodels
import dvae_tpu.train.steps as js
import dvae_tpu_torch.models as tmodels
from dvae_tpu_torch.models.convert import state_dict_from_jax
from dvae_tpu_torch.train import steps as ts
from _torch_port import one_torch_thread  # noqa: F401  (autouse)

F, Z, H, B, LR, STEPS = 513, 16, (32, 32), 32, 1e-4, 5


def _frames(n, seed):
    """Power-spectrogram-like positive rows."""
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.standard_normal((1, F)))
    return (rng.exponential(1.0, (n, F)) * scale + 1e-4).astype(np.float32)


def _unit_rows(n, seed):
    """Rows of unit scale, |N(0, 1)| + 0.1, for the classifier families."""
    return (np.abs(np.random.default_rng(seed).standard_normal((n, F))) + 0.1).astype(
        np.float32)


def _labels(n, y_dim, seed):
    return (np.random.default_rng(seed).uniform(size=(n, y_dim)) > 0.5).astype(np.float32)


def _pair(name, y_dim, seed=0):
    """The JAX model, its weights, and the port's model holding them."""
    jm = getattr(jmodels, name)(x_dim=F, y_dim=y_dim, z_dim=Z, h_dim=H)
    params = jmodels.init_params(
        jm, {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1)},
        jnp.ones((4, F)), jnp.ones((4, y_dim)))
    tm = getattr(tmodels, name)(F, y_dim, Z, H)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


def _noise(jm, params, enc_in, key):
    """The noise the JAX model draws with ``key``, from its encoder's own
    sample (the noise does not depend on the encoder's input)."""
    z, mu, lv = (np.asarray(a, np.float64) for a in jm.apply(
        params, jnp.asarray(enc_in), method="encode", rngs={"sample": key}))
    return torch.from_numpy(((z - mu) * np.exp(-0.5 * lv)).astype(np.float32))


def _close_metrics(got, want, what):
    assert set(got) == set(want), what  # jit returns the keys sorted
    for k in want:
        g = float(got[k])
        assert np.isfinite(g), (what, k)
        np.testing.assert_allclose(g, float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what}: {k}")


def _close_params(tm, jparams, what):
    want = state_dict_from_jax(jax.device_get(jparams))
    for name, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0, atol=2e-6,
                                   err_msg=f"{name} {what}")


def _run(jstep, state, tstep, jm, y_dim, enc_in_fn, check_params, rows=_unit_rows):
    """STEPS steps of both sides on the same batches and noise."""
    for k in range(STEPS):
        x, y = rows(B, 10 + k), _labels(B, y_dim, 20 + k)
        key = jax.random.PRNGKey(100 + k)
        eps = _noise(jm, state.params, enc_in_fn(x, y), key)
        state, wm = jstep(state, jnp.asarray(x), jnp.asarray(y), key)
        gm = tstep(torch.from_numpy(x), torch.from_numpy(y), sample_eps=eps)
        _close_metrics(gm, wm, f"step {k + 1}")
        if k in (0, STEPS - 1):
            check_params(state, f"after {k + 1} steps")
    return state


def _eval_agrees(jeval, jparams, tevaluate, jm, y_dim, enc_in_fn, rows=_unit_rows):
    x, y = rows(B, 90), _labels(B, y_dim, 91)
    key = jax.random.PRNGKey(7)
    eps = _noise(jm, jparams, enc_in_fn(x, y), key)
    want = jeval(jparams, jnp.asarray(x), jnp.asarray(y), key)
    got = tevaluate(torch.from_numpy(x), torch.from_numpy(y), sample_eps=eps)
    _close_metrics(got, want, "eval")


def _norm(rows=_unit_rows):
    x = np.concatenate([rows(B, 10 + k) for k in range(STEPS)])
    return x.mean(0)[:, None], x.std(0)[:, None]


# ---------------------------------------------------------------------------
# the conditional ELBO (M2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("y_dim,std_norm", [(1, False), (513, False), (1, True)],
                         ids=["vad", "ibm", "vad-norm"])
def test_conditional_elbo_steps_match_jax(y_dim, std_norm):
    jm, params, tm = _pair("CVAE", y_dim)
    norm = _norm(_frames) if std_norm else None
    tx = js.adam(LR)
    state = js.init_train_state(jm, params, tx)
    jstep = js.make_train_step(jm, tx, conditional=True, norm=norm)
    opt = ts.adam(tm.parameters(), LR)
    tstep = ts.make_train_step(tm, opt, conditional=True, norm=norm)
    enc_in = lambda x, y: np.concatenate([x, y], -1)  # noqa: E731  (CVAE encodes [x; y])
    state = _run(jstep, state, tstep, jm, y_dim, enc_in,
                 lambda st, what: _close_params(tm, st.params, what), _frames)
    _eval_agrees(js.make_eval_step(jm, conditional=True, norm=norm), state.params,
                 ts.make_eval_step(tm, conditional=True, norm=norm), jm, y_dim, enc_in,
                 _frames)


# ---------------------------------------------------------------------------
# the semi-supervised step (M2v3)
# ---------------------------------------------------------------------------

SEMISUP = [(o, c, a) for o in ("uloss", "lloss")
           for c in ("soft", "yhathard", "hardlabel", "ytrue") for a in (-10.0, 10.0)]
# alpha 0 with a hard label: the classifier gets no gradient at all, and
# must still count Adam steps as optax does
SEMISUP += [("uloss", "hardlabel", 0.0), ("lloss", "yhathard", 0.0)]


@pytest.mark.parametrize("objective,y_cond,alpha", SEMISUP,
                         ids=[f"{o}-{c}-{a:+g}" for o, c, a in SEMISUP])
def test_semisup_steps_match_jax(objective, y_cond, alpha):
    jm, params, tm = _pair("CVAE_v3", 1)
    tx = js.adam(LR)
    state = js.init_train_state(jm, params, tx)
    jstep = js.make_semisup_step(jm, tx, objective, alpha, y_cond)
    opt = ts.adam(tm.parameters(), LR)
    tstep = ts.make_semisup_step(tm, opt, objective, alpha, y_cond)
    clf0 = {k: v.clone() for k, v in tm.classifier.state_dict().items()}
    state = _run(jstep, state, tstep, jm, 1, lambda x, y: x,
                 lambda st, what: _close_params(tm, st.params, what))
    if alpha == 0.0:
        assert all(torch.equal(clf0[k], v) for k, v in tm.classifier.state_dict().items())
        steps = {int(s["step"]) for s in opt.state_dict()["state"].values()}
        assert steps == {STEPS}, steps  # every parameter counted every step
    _eval_agrees(js.make_semisup_eval_step(jm, objective, alpha, y_cond), state.params,
                 ts.make_semisup_eval_step(tm, objective, alpha, y_cond), jm, 1,
                 lambda x, y: x)


def test_semisup_rejects_unknown_options():
    tm = tmodels.CVAE_v3(F, 1, Z, H)
    with pytest.raises(ValueError, match="objective"):
        ts.make_semisup_step(tm, ts.adam(tm.parameters()), "bogus", 1.0)
    with pytest.raises(ValueError, match="y_cond"):
        ts.make_semisup_eval_step(tm, "uloss", 1.0, "bogus")


# ---------------------------------------------------------------------------
# the adversarial step (M2-info v5, CVAE_v4)
# ---------------------------------------------------------------------------

PUBLISHED = dict(alpha=0.0, beta=10.0, gamma=1.0)  # training_M2_info_vad.py:19-21
ADVERSARIAL = {
    "v5-bce": dict(PUBLISHED),
    "v5-bce-legacy": dict(PUBLISHED, legacy_aux_coupling=True),
    "v5-uniform": dict(PUBLISHED, enc_adversary="uniform"),
    "v5-uniform-legacy": dict(PUBLISHED, enc_adversary="uniform", legacy_aux_coupling=True),
    "v5-entropy": dict(PUBLISHED, enc_adversary="entropy"),
    "v5-entropy-legacy": dict(PUBLISHED, enc_adversary="entropy", legacy_aux_coupling=True),
    "v5-freeze": dict(alpha=1.0, beta=1.0, gamma=1.0, freeze_substring="classifier"),
    "v5-norm": dict(PUBLISHED, norm=True),
    "v5-soft": dict(alpha=1.0, beta=10.0, gamma=1.0, use_y_hat_soft=True),
    "v5-gamma0": dict(alpha=0.0, beta=10.0, gamma=0.0),
    "v5-ibm": dict(PUBLISHED, y_dim=513),
    "v4-hardlabel": dict(alpha=10.0, beta=10.0, gamma=1.0, y_cond="hardlabel", layout="v4"),
    "v4-yhathard-entropy-legacy": dict(PUBLISHED, y_cond="yhathard", enc_adversary="entropy",
                                       legacy_aux_coupling=True, layout="v4"),
    "v4-soft-freeze-norm": dict(alpha=1.0, beta=1.0, gamma=1.0, y_cond="soft",
                                freeze_substring="classifier", norm=True, layout="v4"),
    "v4-ytrue-uniform": dict(PUBLISHED, enc_adversary="uniform", layout="v4"),
}


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_adversarial_steps_match_jax(case):
    kw = dict(ADVERSARIAL[case])
    layout, y_dim = kw.pop("layout", "v5"), kw.pop("y_dim", 1)
    alpha, beta, gamma = kw.pop("alpha"), kw.pop("beta"), kw.pop("gamma")
    if kw.pop("norm", False):
        kw["norm"] = _norm()
    jm, params, tm = _pair("DisentangledVAE" if layout == "v5" else "CVAE_v4", y_dim)
    assert js._adversarial_layout(params) == ts._adversarial_layout(tm) == layout
    tx_e, tx_a = js.adam(LR), js.adam(LR)
    state = js.init_adversarial_state(params, tx_e, tx_a)
    jstep = js.make_adversarial_step(jm, tx_e, tx_a, alpha, beta, gamma, layout=layout, **kw)
    opt_enc, opt_aux = ts.init_adversarial_state(tm, LR)
    tstep = ts.make_adversarial_step(tm, opt_enc, opt_aux, alpha, beta, gamma, **kw)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    state = _run(jstep, state, tstep, jm, y_dim, lambda x, y: x,
                 lambda st, what: _close_params(tm, st.params, what))
    moved = {k.removeprefix("enc_dec_clf.").split(".")[0]
             for k, v in tm.state_dict().items() if not torch.equal(before[k], v)}
    assert {"encoder", "decoder"} <= moved
    # the auxiliary moves unless its loss is 0 (then it steps on zero gradients)
    assert ("auxiliary" in moved) == bool(gamma or kw.get("legacy_aux_coupling"))
    if "freeze_substring" in kw:
        assert "classifier" not in moved
    for opt in (opt_enc, opt_aux):
        assert {int(s["step"]) for s in opt.state_dict()["state"].values()} == {STEPS}
    ekw = {k: v for k, v in kw.items() if k in ("use_y_hat_soft", "y_cond", "norm",
                                                  "enc_adversary")}
    _eval_agrees(js.make_adversarial_eval_step(jm, alpha, beta, gamma, **ekw), state.params,
                 ts.make_adversarial_eval_step(tm, alpha, beta, gamma, **ekw), jm, y_dim,
                 lambda x, y: x)


def test_adversarial_groups_and_refusals():
    v5 = tmodels.DisentangledVAE(F, 1, Z, H)
    enc, aux = ts.adversarial_groups(v5)
    assert {n.split(".")[0] for n, _ in enc} == {"encoder", "decoder", "classifier"}
    assert len(aux) == len(list(v5.auxiliary.parameters()))
    v4 = tmodels.CVAE_v4(F, 1, Z, H)
    enc4, _ = ts.adversarial_groups(v4)
    assert [n for n, _ in enc4] == [n for n, _ in enc]  # the same names in both layouts
    with pytest.raises(ValueError, match="auxiliary"):
        ts.adversarial_groups(tmodels.CVAE_v3(F, 1, Z, H))
    opt_e, opt_a = ts.init_adversarial_state(v5)
    with pytest.raises(ValueError, match="enc_adversary"):
        ts.make_adversarial_step(v5, opt_e, opt_a, 0.0, 1.0, 1.0, enc_adversary="bogus")
    with pytest.raises(ValueError, match="y_cond"):
        ts.make_adversarial_eval_step(v5, 0.0, 1.0, 1.0, y_cond="bogus")
