"""Training steps (port of the M1 part of ``dvae_tpu.train.steps``).

Adam on the Itakura-Saito negative ELBO, as the reference loop
(training_M1.py:122-139). A step updates the model and optimizer in place
and returns its metrics as 0-d tensors on the model's device, so a loop
that does not read them every step never waits on the device.

Not ported yet: the multi-step dispatch (a CUDA graph in this port), the
device-gather steps (``loop.fit_vae(device_data=True)`` gathers instead),
the conditional (M2) step, the semi-supervised step and the adversarial
M2-info step (ROADMAP A9, A12).
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


def _not_conditional(conditional: bool) -> None:
    if conditional:
        raise NotImplementedError(
            "conditional (M2) training is not ported yet (ROADMAP A9)")


def make_train_step(model, opt: torch.optim.Optimizer, conditional: bool = False,
                    eps: float = 1e-8, norm=None) -> Callable:
    """``step(x, generator=None, sample_eps=None) -> metrics``: one Adam
    update of ``model`` on the batch ``x`` (B, F). The reparameterization
    noise is ``sample_eps`` when given, else drawn from ``generator``."""
    _not_conditional(conditional)
    normalize = _normalizer(norm, eps, next(model.parameters()).device)

    def step(x, generator=None, sample_eps=None):
        model.train()
        opt.zero_grad(set_to_none=True)
        r, mu, logvar = model(normalize(x), generator=generator, eps=sample_eps)
        total, recon, kl = losses.elbo(x, r, mu, logvar, eps)
        total.backward()
        opt.step()
        return {"elbo": total.detach(), "recon": recon.detach(), "kl": kl.detach()}

    return step


def make_eval_step(model, conditional: bool = False, eps: float = 1e-8,
                   norm=None) -> Callable:
    """``evaluate(x, generator=None, sample_eps=None) -> metrics``, without
    an update; z is sampled as in training."""
    _not_conditional(conditional)
    normalize = _normalizer(norm, eps, next(model.parameters()).device)

    @torch.no_grad()
    def evaluate(x, generator=None, sample_eps=None):
        model.eval()
        r, mu, logvar = model(normalize(x), generator=generator, eps=sample_eps)
        total, recon, kl = losses.elbo(x, r, mu, logvar, eps)
        return {"elbo": total, "recon": recon, "kl": kl}

    return evaluate
