"""Plain reference of ``m1``: the plain VAE (``VAE(513, 16, (128, 128))``).
The encoder sees |X|^2; the decoder's hidden widths are the encoder's
reversed; no labels."""

from benchmark.reference import nets


def params(cfg: dict) -> list:
    m = cfg["model"]
    return (nets.encoder_params("encoder", m["x_dim"], m["h_dim"], m["z_dim"])
            + nets.decoder_params("decoder", m["z_dim"], m["h_dim"], m["x_dim"]))


def encoder_mean(w: dict, cfg: dict, x2, prec):
    return nets.encoder_mean(w, "encoder", len(cfg["model"]["h_dim"]), x2, prec)


def decoder(w: dict, cfg: dict):
    return nets.decoder(w, "decoder", len(cfg["model"]["h_dim"]), cfg["model"]["z_dim"])


def labels(w: dict, cfg: dict, x2, prec):
    return None
