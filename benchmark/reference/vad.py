"""Plain forward pass of the video voice-activity network (the port's
``VideoVad``: three 3x3 stride-2 convs over 67x67 lip crops, a tanh
projection, a stacked LSTM and a sigmoid head), over a dict of weights
named as its ``state_dict``.

Float32 with the products at the precision's ``mm`` bits: ``F.conv2d`` on
rounded operands, and the LSTM's gates written out as products (torch's
i, f, g, o order, zero initial state), never cuDNN's fused LSTM.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.dsp import Stft
from benchmark.reference.precision import Precision, round_bits

SIDE, KERNEL, STRIDE = 67, 3, 2


def _out(size: int) -> int:
    return -(-size // STRIDE)


def same_padding(size: int) -> tuple[int, int]:
    """(low, high) padding of one axis under Flax's ``SAME`` rule: a total
    of max((out - 1) stride + k - in, 0), the smaller half low."""
    total = max((_out(size) - 1) * STRIDE + KERNEL - size, 0)
    return total // 2, total - total // 2


def lstm_params(prefix: str, in_dim: int, hidden: int, layers: int) -> list:
    """``nn.LSTM``'s tensors, drawn as torch draws them (U(+-1/sqrt(hidden)))
    but ``bias_ih``, which the port holds at zero."""
    bound = hidden ** -0.5
    out = []
    for k in range(layers):
        out += [(f"{prefix}.weight_ih_l{k}", (4 * hidden, in_dim if k == 0 else hidden),
                 "uniform", bound),
                (f"{prefix}.weight_hh_l{k}", (4 * hidden, hidden), "uniform", bound),
                (f"{prefix}.bias_ih_l{k}", (4 * hidden,), "zero"),
                (f"{prefix}.bias_hh_l{k}", (4 * hidden,), "uniform", bound)]
    return out


def video_vad_params(hidden: int, num_layers: int, emb_dim: int, conv_features) -> list:
    """(name, shape, init) of every tensor of ``VideoVad``: Xavier-normal
    kernels and zero biases for the convs, the projection and the head."""
    chans = (1, *conv_features)
    out, side = [], SIDE
    for i in range(len(conv_features)):
        out += [(f"lip.convs.{i}.weight", (chans[i + 1], chans[i], KERNEL, KERNEL), "xavier"),
                (f"lip.convs.{i}.bias", (chans[i + 1],), "zero")]
        side = _out(side)
    out += [("lip.proj.weight", (emb_dim, side * side * chans[-1]), "xavier"),
            ("lip.proj.bias", (emb_dim,), "zero")]
    out += lstm_params("lstm", emb_dim, hidden, num_layers)
    return out + [("head.weight", (1, hidden), "xavier"), ("head.bias", (1,), "zero")]


def lip_embedding(w: dict, video: torch.Tensor, n_convs: int, prec: Precision) -> torch.Tensor:
    """(B, T, 67, 67) normalized crops -> (B, T, emb): relu convs with SAME
    padding, the map flattened in H, W, C order, a tanh projection."""
    b, t = video.shape[:2]
    h = video.reshape(b * t, 1, *video.shape[2:]).float()
    for i in range(n_convs):
        ph, pw = same_padding(h.shape[-2]), same_padding(h.shape[-1])
        h = F.pad(h, (*pw, *ph))
        h = torch.relu(F.conv2d(round_bits(h, prec.mm), round_bits(w[f"lip.convs.{i}.weight"],
                                                                    prec.mm),
                                w[f"lip.convs.{i}.bias"], stride=STRIDE))
    h = h.permute(0, 2, 3, 1).reshape(b, t, -1)
    return torch.tanh(prec.matmul(h, w["lip.proj.weight"].t()) + w["lip.proj.bias"])


def lstm(w: dict, prefix: str, x: torch.Tensor, layers: int, prec: Precision) -> torch.Tensor:
    """(B, T, in) -> (B, T, hidden): each layer's input products for every
    step at once, then the recurrence step by step."""
    for k in range(layers):
        w_hh = w[f"{prefix}.weight_hh_l{k}"]
        gx = (prec.matmul(x, w[f"{prefix}.weight_ih_l{k}"].t()) + w[f"{prefix}.bias_ih_l{k}"]
              + w[f"{prefix}.bias_hh_l{k}"])
        hidden = w_hh.shape[1]
        h = x.new_zeros((x.shape[0], hidden))
        c = torch.zeros_like(h)
        outs = []
        for step in range(x.shape[1]):
            g = gx[:, step] + prec.matmul(h, w_hh.t())
            i, f, u, o = g.split(hidden, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs, 1)
    return x


def video_vad(w: dict, video: torch.Tensor, n_convs: int, layers: int,
              prec: Precision) -> torch.Tensor:
    """Per-frame VAD probability (B, T) of (B, T, 67, 67) normalized crops."""
    h = lstm(w, "lstm", lip_embedding(w, video, n_convs, prec), layers, prec)
    return torch.sigmoid(prec.matmul(h, w["head.weight"].t()) + w["head.bias"])[..., 0]


def video_labels(w: dict, cfg: dict, wavs, side: dict, prec: Precision) -> list:
    """Per-mixture (frames, 1) labels of the configuration's ``label_net``
    (a ``VideoVad``: ``hidden``, ``num_layers``, ``conv_features``) from
    each mixture's clip (``side["video"]``, one 8-bit crop per STFT frame),
    normalized by ``label_net.stats.video`` (the pixels' mean and std). The
    clips are zero-padded to the longest: every layer runs forward in time,
    so no valid frame sees the padding."""
    net = cfg["label_net"]
    st = Stft(**cfg["stft"])
    frames = [st.frames(len(x)) for x in wavs]
    clips = np.zeros((len(wavs), max(frames), SIDE, SIDE), np.uint8)
    for i, (clip, f) in enumerate(zip(side["video"], frames)):
        clips[i, :f] = clip[:f]
    mean, std = net["stats"]["video"]
    dev = next(iter(w.values())).device
    x = (torch.from_numpy(clips).to(dev).float() - mean) / std
    p = video_vad(w, x, len(net["conv_features"]), net["num_layers"], prec)
    return [p[i, :f, None] for i, f in enumerate(frames)]
