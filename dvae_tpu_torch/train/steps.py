"""Training steps for every frame-level model family (port of
``dvae_tpu.train.steps``).

* M1 / M2: Adam on the Itakura-Saito negative ELBO (training_M1.py:
  122-139, training_M2.py), the conditional step feeding the labels to the
  model.
* M2v3: the semi-supervised ``uloss`` / ``lloss`` objective, one loss
  shared by the train and eval steps.
* M2-info and CVAE_v4: the two-player adversarial step of
  training_M2_info_vad.py:153-198. The encoder group (encoder, decoder and
  x -> y classifier) steps first on ``ELBO + alpha * BCE(y_hat_x, y) -
  beta * adversary(y_hat_z, y)``; then the z -> y auxiliary steps on the
  same batch's latents, detached, taken before the encoder's update.

A step updates the model and its optimizers in place and returns its
metrics as 0-d tensors on the model's device, so a loop that does not read
them every step never waits on the device. A parameter that a loss does
not reach steps on a zero gradient: Adam then counts one step for every
parameter, as optax does, where ``torch.optim.Adam`` would skip a
parameter whose ``grad`` is None.

The reparameterization noise is ``sample_eps`` when given, else drawn from
``generator``. Not ported: the multi-step dispatch (``steps_per_dispatch >
1``, a CUDA graph in this port, ROADMAP A12.5).
"""

from __future__ import annotations

from typing import Callable

import torch

from dvae_tpu_torch.models import losses


def adam(params, lr: float = 1e-4) -> torch.optim.Adam:
    """The reference's optimizer everywhere (training_M1.py:115). Equal to
    ``optax.adam(lr, b1=0.9, b2=0.999)``: eps 1e-8 outside the square root,
    no eps inside it, bias-corrected moments."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _normalizer(norm, eps, device=None) -> Callable:
    """Input normalization used when std_norm is on (training_M1.py:101-133):
    the model sees (x - mean) / (std + eps); the ELBO compares against raw x."""
    if norm is None:
        return lambda x: x
    mean, std = (torch.as_tensor(a, dtype=torch.float32, device=device).reshape(-1)
                 for a in norm)
    return lambda x: (x - mean) / (std + eps)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _fill_missing_grads(opt) -> None:
    """A zero gradient for every parameter of ``opt`` that the backward did
    not reach, so that Adam steps it as optax does."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# M1 / M2 ELBO training
# ---------------------------------------------------------------------------


def _elbo_fn(model, conditional: bool, eps: float, norm) -> Callable:
    """``(x, y, generator, sample_eps) -> (total, recon, kl)``: the one ELBO
    of the train and eval steps."""
    normalize = _normalizer(norm, eps, _device(model))

    def elbo(x, y, generator, sample_eps):
        x_in = normalize(x)
        if conditional:
            if y is None:
                raise ValueError("a conditional step needs the labels y")
            r, mu, logvar = model(x_in, y, generator=generator, eps=sample_eps)
        else:
            r, mu, logvar = model(x_in, generator=generator, eps=sample_eps)
        return losses.elbo(x, r, mu, logvar, eps)

    return elbo


def make_train_step(model, opt: torch.optim.Optimizer, conditional: bool = False,
                    eps: float = 1e-8, norm=None) -> Callable:
    """``step(x, y=None, generator=None, sample_eps=None) -> metrics``: one
    Adam update of ``model`` on the batch ``x`` (B, F), conditioned on the
    labels ``y`` (B, Yd) when ``conditional``."""
    elbo = _elbo_fn(model, conditional, eps, norm)

    def step(x, y=None, generator=None, sample_eps=None):
        model.train()
        opt.zero_grad(set_to_none=True)
        total, recon, kl = elbo(x, y, generator, sample_eps)
        total.backward()
        _fill_missing_grads(opt)
        opt.step()
        return _detached({"elbo": total, "recon": recon, "kl": kl})

    return step


def make_eval_step(model, conditional: bool = False, eps: float = 1e-8,
                   norm=None) -> Callable:
    """``evaluate(x, y=None, generator=None, sample_eps=None) -> metrics``,
    without an update; z is sampled as in training."""
    elbo = _elbo_fn(model, conditional, eps, norm)

    @torch.no_grad()
    def evaluate(x, y=None, generator=None, sample_eps=None):
        model.eval()
        total, recon, kl = elbo(x, y, generator, sample_eps)
        return {"elbo": total, "recon": recon, "kl": kl}

    return evaluate


# ---------------------------------------------------------------------------
# M2v3 semi-supervised training (U_loss / L_loss)
# ---------------------------------------------------------------------------


def _semisup_loss_fn(model, objective: str, alpha: float, y_cond: str,
                     eps: float) -> Callable:
    """The one semi-supervised loss of the train and eval steps, so that the
    validation loss that names and picks checkpoints is the trained one.
    Returns ``(x, y, generator, sample_eps) -> (loss, metrics)``."""
    if objective not in ("uloss", "lloss"):
        raise ValueError(f"objective must be uloss|lloss, got {objective!r}")
    if y_cond not in ("soft", "yhathard", "hardlabel", "ytrue"):
        raise ValueError(f"unknown y_cond {y_cond!r}")

    def loss_fn(x, y, generator=None, sample_eps=None):
        y_hat_soft = model.classify(x)
        hard = (y_hat_soft > 0.5).to(x.dtype).detach()
        cond = {"soft": y_hat_soft, "yhathard": hard,
                "hardlabel": hard, "ytrue": y}[y_cond]
        r, mu, logvar = model(x, cond, generator=generator, eps=sample_eps)
        if objective == "uloss":
            marg = hard if y_cond == "hardlabel" else y_hat_soft
            total, L, recon, kl = losses.U_loss(x, r, mu, logvar, marg, eps)
        else:
            Lp, recon_p, kl_p = losses.L_loss(x, r, mu, logvar, eps)
            total = torch.mean(Lp)
            L, recon, kl = total, torch.mean(recon_p), torch.mean(kl_p)
        classif = losses.binary_cross_entropy(y_hat_soft, y, eps)
        # a zero-weighted term is left out, not multiplied by 0: at BCE
        # saturation its gradient is inf, and 0 * inf = nan
        loss = total
        if alpha:
            loss = loss - alpha * classif
        return loss, {"loss": loss, "objective": total, "l": L,
                      "recon": recon, "kl": kl, "classif": classif}

    return loss_fn


def make_semisup_step(model, opt: torch.optim.Optimizer, objective: str, alpha: float,
                      y_cond: str = "soft", eps: float = 1e-8) -> Callable:
    """``step(x, y, generator=None, sample_eps=None) -> metrics``: one Adam
    update of a ``CVAE_v3`` on the semi-supervised objective (``uloss`` or
    ``lloss``) minus ``alpha * BCE(y_hat_soft, y)``; a positive alpha pushes
    the x -> y classifier away from the labels. ``y_cond`` picks what
    conditions the decoder: the soft prediction, its hard version under
    ``detach()`` (``yhathard``; ``hardlabel`` also marginalizes U over it),
    or the true label. The JAX package's docstring gives the evidence the
    objective was reconstructed from."""
    loss_fn = _semisup_loss_fn(model, objective, alpha, y_cond, eps)

    def step(x, y, generator=None, sample_eps=None):
        model.train()
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(x, y, generator, sample_eps)
        loss.backward()
        _fill_missing_grads(opt)
        opt.step()
        return _detached(metrics)

    return step


def make_semisup_eval_step(model, objective: str, alpha: float, y_cond: str = "soft",
                           eps: float = 1e-8) -> Callable:
    loss_fn = _semisup_loss_fn(model, objective, alpha, y_cond, eps)

    @torch.no_grad()
    def evaluate(x, y, generator=None, sample_eps=None):
        model.eval()
        return loss_fn(x, y, generator, sample_eps)[1]

    return evaluate


# ---------------------------------------------------------------------------
# M2-info adversarial training
# ---------------------------------------------------------------------------


def _adversarial_layout(model) -> str:
    """'v5' for ``DisentangledVAE`` (``enc_dec_clf`` + ``auxiliary``), 'v4'
    for ``CVAE_v4`` (encoder, decoder, classifier and auxiliary side by
    side)."""
    if not hasattr(model, "auxiliary"):
        raise ValueError(f"{type(model).__name__} has no z -> y auxiliary classifier")
    return "v5" if hasattr(model, "enc_dec_clf") else "v4"


def adversarial_groups(model):
    """(the encoder player's named parameters, the auxiliary's parameters),
    names relative to the player as the JAX package's groups have them
    (``classifier.output_layer.weight`` in either layout)."""
    if _adversarial_layout(model) == "v5":
        enc = list(model.enc_dec_clf.named_parameters())
    else:
        enc = [(n, p) for n, p in model.named_parameters()
               if not n.startswith("auxiliary.")]
    return enc, list(model.auxiliary.parameters())


def init_adversarial_state(model, lr: float = 1e-4):
    """The two players' Adams: (encoder group's, auxiliary's)."""
    enc, aux = adversarial_groups(model)
    return adam([p for _, p in enc], lr), adam(aux, lr)


def _enc_adversary_fn(enc_adversary: str, eps: float) -> Callable:
    """The encoder's -beta adversary term, by the reference's
    ``Lenc_aux_v*`` tags: 'bce' (labelled BCE), 'uniform' (BCE against 0.5),
    'entropy' (the prediction's own entropy)."""
    if enc_adversary not in ("bce", "uniform", "entropy"):
        raise ValueError(f"unknown enc_adversary {enc_adversary!r}")

    def adv_fn(y_hat_z, y):
        if enc_adversary == "bce":
            return losses.binary_cross_entropy(y_hat_z, y, eps)
        if enc_adversary == "uniform":
            return losses.binary_cross_entropy_v2(y_hat_z, eps)
        return losses.binary_cross_entropy_v3(y_hat_z, eps)

    return adv_fn


def _cond_mode(y_cond, use_y_hat_soft: bool) -> str:
    mode = y_cond or ("soft" if use_y_hat_soft else "ytrue")
    if mode not in ("ytrue", "soft", "yhathard", "hardlabel"):
        raise ValueError(f"unknown y_cond {mode!r}")
    return mode


def _make_adversarial_losses(model, alpha, beta, eps, cond_mode, normalize, adv_fn):
    """The one encoder-loss assembly of the train and eval steps (the eval
    value names checkpoints and picks the best). Returns ``(x, y,
    generator, sample_eps) -> (enc_loss, z, metrics, aux_bce)``, where
    ``aux_bce`` is the auxiliary's labelled BCE whatever the encoder's
    adversary is."""

    def compute(x, y, generator=None, sample_eps=None):
        x_in = normalize(x)
        y_hat_x = model.classify_from_x(x_in)
        hard = (y_hat_x > 0.5).to(x.dtype).detach()
        cond = {"ytrue": y, "soft": y_hat_x,
                "yhathard": hard, "hardlabel": hard}[cond_mode]
        r, z, mu, logvar = model(x_in, cond, generator=generator, eps=sample_eps)
        elbo_val, recon, kl = losses.elbo(x, r, mu, logvar, eps)
        classif = losses.binary_cross_entropy(y_hat_x, y, eps)
        y_hat_z = model.classify_from_z(z)
        aux_enc = adv_fn(y_hat_z, y)
        aux_bce = losses.binary_cross_entropy(y_hat_z, y, eps)
        # zero-weighted terms are left out, not multiplied by 0: a saturated
        # sigmoid makes dBCE inf and 0 * inf = nan, which the published
        # alpha=0 (training_M2_info_vad.py:53) would hit
        enc_loss = elbo_val
        if alpha:
            enc_loss = enc_loss + alpha * classif
        if beta:
            enc_loss = enc_loss - beta * aux_enc
        metrics = {"elbo": elbo_val, "recon": recon, "kl": kl, "enc": enc_loss,
                   "classif": alpha * classif, "aux_enc": aux_enc}
        return enc_loss, z, metrics, aux_bce

    return compute


def make_adversarial_step(model, opt_enc: torch.optim.Optimizer,
                          opt_aux: torch.optim.Optimizer, alpha: float, beta: float,
                          gamma: float, eps: float = 1e-8,
                          legacy_aux_coupling: bool = False, use_y_hat_soft: bool = False,
                          freeze_substring: str | None = None, y_cond: str | None = None,
                          norm=None, enc_adversary: str = "bce") -> Callable:
    """``step(x, y, generator=None, sample_eps=None) -> metrics``: one move
    of each player, on a ``DisentangledVAE`` or a ``CVAE_v4`` with the
    optimizers of :func:`init_adversarial_state`.

    ``y_cond`` picks the decoder's label: 'ytrue' (the default), 'soft'
    (also ``use_y_hat_soft=True``, the pretrain script's), or the hard
    prediction under ``detach()`` ('yhathard' / 'hardlabel').
    ``freeze_substring`` zeroes the encoder group's gradients whose name
    (torch's dotted name within the group) holds it, before Adam. ``norm``
    = (mean, std) normalizes every model input while the ELBO compares raw
    x. ``enc_adversary`` is the encoder's -beta term (see
    :func:`_enc_adversary_fn`).

    The auxiliary trains on ``+gamma * BCE``. ``enc_loss.backward()`` also
    fills the auxiliary's gradient buffers (with ``-beta * d adversary``);
    they are cleared before the auxiliary's own backward. The reference
    never clears them, so its auxiliary follows ``gamma * dBCE - beta * d
    adversary``: ``legacy_aux_coupling=True`` trains on that loss, on the
    detached z. Metrics: ``elbo recon kl enc classif aux_enc aux``."""
    adv_fn = _enc_adversary_fn(enc_adversary, eps)
    compute = _make_adversarial_losses(
        model, alpha, beta, eps, _cond_mode(y_cond, use_y_hat_soft),
        _normalizer(norm, eps, _device(model)), adv_fn)
    enc, _ = adversarial_groups(model)
    frozen = [p for n, p in enc if freeze_substring is not None and freeze_substring in n]
    has_gamma = bool(gamma)
    has_legacy = legacy_aux_coupling and bool(beta)

    def step(x, y, generator=None, sample_eps=None):
        model.train()
        opt_enc.zero_grad(set_to_none=True)
        enc_loss, z, metrics, _ = compute(x, y, generator, sample_eps)
        enc_loss.backward()
        _fill_missing_grads(opt_enc)
        for p in frozen:
            p.grad.zero_()
        opt_enc.step()

        # the auxiliary moves on the latents of the encoder before its step;
        # enc_loss.backward() left -beta * d adversary in its gradients
        opt_aux.zero_grad(set_to_none=True)
        if has_gamma or has_legacy:
            y_hat_z = model.classify_from_z(z.detach())
            aux_loss = torch.zeros((), device=x.device)
            if has_gamma:
                aux_loss = aux_loss + gamma * losses.binary_cross_entropy(y_hat_z, y, eps)
            if has_legacy:
                aux_loss = aux_loss - beta * adv_fn(y_hat_z, y)
            aux_loss.backward()
        else:
            aux_loss = torch.zeros((), device=x.device)
        _fill_missing_grads(opt_aux)
        opt_aux.step()
        metrics["aux"] = aux_loss
        return _detached(metrics)

    return step


def make_adversarial_eval_step(model, alpha: float, beta: float, gamma: float,
                               eps: float = 1e-8, use_y_hat_soft: bool = False,
                               y_cond: str | None = None, norm=None,
                               enc_adversary: str = "bce") -> Callable:
    """``evaluate(x, y, generator=None, sample_eps=None) -> metrics`` of the
    train step's loss assembly, ``elbo recon kl enc classif aux`` with
    ``aux = gamma * BCE(y_hat_z, y)``."""
    compute = _make_adversarial_losses(
        model, alpha, beta, eps, _cond_mode(y_cond, use_y_hat_soft),
        _normalizer(norm, eps, _device(model)), _enc_adversary_fn(enc_adversary, eps))

    @torch.no_grad()
    def evaluate(x, y, generator=None, sample_eps=None):
        model.eval()
        _, _, metrics, aux_bce = compute(x, y, generator, sample_eps)
        del metrics["aux_enc"]
        metrics["aux"] = gamma * aux_bce
        return metrics

    return evaluate
