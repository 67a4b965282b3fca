"""Plain reference of ``m2info_av``: the disentangled VAE of ``m2info``
(``DisentangledVAE(513, 1, 16, (128, 128))``) on per-frame labels that a
video voice-activity network (``VideoVad(512, 2, 128, (8, 16, 32))``)
makes from each mixture's lip video (``reference/vad.py``). The prior's
classifier is not used: the labels are the network's."""

from benchmark import work
from benchmark.reference import nets, vad

PRIOR = "enc_dec_clf"


def params(cfg: dict) -> list:
    m = cfg["model"]
    x, y, z, h = m["x_dim"], m["y_dim"], m["z_dim"], m["h_dim"]
    return (nets.encoder_params(f"{PRIOR}.encoder", x, h, z)
            + nets.decoder_params(f"{PRIOR}.decoder", z + y, h, x)
            + nets.classifier_params(f"{PRIOR}.classifier", x, h, y)
            + nets.classifier_params("auxiliary", z, h, y))


def encoder_mean(w: dict, cfg: dict, x2, prec):
    return nets.encoder_mean(w, f"{PRIOR}.encoder", len(cfg["model"]["h_dim"]), x2, prec)


def decoder(w: dict, cfg: dict):
    return nets.decoder(w, f"{PRIOR}.decoder", len(cfg["model"]["h_dim"]), cfg["model"]["z_dim"])


def label_params(cfg: dict) -> list:
    n = cfg["label_net"]
    return vad.video_vad_params(n["hidden"], n["num_layers"], n["emb_dim"], n["conv_features"])


net_labels = vad.video_labels


def label_flops(cfg: dict, frames: int) -> float:
    n = cfg["label_net"]
    return work.video_vad_flops(frames, n["hidden"], n["num_layers"], n["emb_dim"],
                                n["conv_features"])
