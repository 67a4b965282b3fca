"""Plain reference of ``m2info``: the disentangled VAE
(``DisentangledVAE(513, 1, 16, (128, 128))``, the reference's
``DeepGenerativeModel_v5``). A label-free encoder, a decoder over [z; y],
a relu x -> y classifier that gives the self-soft labels from the noisy
power, and the z -> y auxiliary classifier (trained adversarially; unused
by enhancement)."""

from benchmark.reference import nets


def params(cfg: dict) -> list:
    m = cfg["model"]
    x, y, z, h = m["x_dim"], m["y_dim"], m["z_dim"], m["h_dim"]
    return (nets.encoder_params("enc_dec_clf.encoder", x, h, z)
            + nets.decoder_params("enc_dec_clf.decoder", z + y, h, x)
            + nets.classifier_params("enc_dec_clf.classifier", x, h, y)
            + nets.classifier_params("auxiliary", z, h, y))


def encoder_mean(w: dict, cfg: dict, x2, prec):
    return nets.encoder_mean(w, "enc_dec_clf.encoder", len(cfg["model"]["h_dim"]), x2, prec)


def decoder(w: dict, cfg: dict):
    return nets.decoder(w, "enc_dec_clf.decoder", len(cfg["model"]["h_dim"]),
                        cfg["model"]["z_dim"])


def labels(w: dict, cfg: dict, x2, prec):
    """Per-frame label probabilities from the noisy power (frames, F)."""
    return nets.classify(w, "enc_dec_clf.classifier", len(cfg["model"]["h_dim"]), x2, prec)
