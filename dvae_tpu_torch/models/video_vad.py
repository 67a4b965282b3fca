"""Visual and audio-visual voice-activity classifiers (port of
``dvae_tpu.models.video_vad``).

* :class:`LipEncoder`: 67x67 lip-ROI frames -> a tanh embedding per frame,
  three stride-2 3x3 convs (67 -> 34 -> 17 -> 9) batched over every
  (batch x time) frame, then a projection;
* :class:`VideoVad`: the lip encoder, a stacked LSTM and a sigmoid head;
* :class:`AVVad`: the noisy log-power frames concatenated with the lip
  embedding, then the same LSTM and head.

Padded frames flow through the network; the sequence trainer masks them
out of every reduction. Three layouts follow Flax's, so that
``models.convert.video_vad_state_dict_from_jax`` carries weights across
unchanged:

* the convs pad as Flax's ``padding="SAME"`` does: a total of
  ``max((out - 1) * stride + k - in, 0)``, the smaller half low. At stride
  2 that is asymmetric where the input is even (34 -> 17 pads (0, 1)), so
  each layer's padding is derived from its input size;
* the (9, 9, 32) map is flattened in H, W, C order, Flax's NHWC reshape,
  before the projection;
* the LSTM is ``nn.LSTM`` with ``bias_ih`` held at zero and not trained,
  as in :class:`~dvae_tpu_torch.models.lstm_vad.LSTMVad`.

The convs and the LSTM run on cuDNN on the card, in float32 (the package
turns cuDNN's TF32 off at import).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dvae_tpu_torch.models.lstm_vad import init_lstm_head

_KERNEL, _STRIDE = 3, 2
SIDE = 67  # the lip ROI's height and width


def same_padding(size: int) -> tuple[int, int]:
    """(low, high) padding of one axis of the 3x3 stride-2 convs under
    Flax's ``SAME`` rule."""
    out = -(-size // _STRIDE)
    total = max((out - 1) * _STRIDE + _KERNEL - size, 0)
    return total // 2, total - total // 2


def flatten_hwc(h: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H * W * C), in Flax's NHWC reshape order."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _conv_out(size: int) -> int:
    return -(-size // _STRIDE)


class LipEncoder(nn.Module):
    """Per-frame 67x67 lip ROI -> embedding, batched over all frames.

    Inputs are expected normalized with the video builder's pixel
    statistics, which the sequence trainer's ``norm`` applies."""

    def __init__(self, emb_dim: int = 128, conv_features: Sequence[int] = (8, 16, 32),
                 generator: torch.Generator | None = None):
        super().__init__()
        chans = (1, *conv_features)
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], _KERNEL, _STRIDE)
                                   for i in range(len(conv_features)))
        side = SIDE
        for _ in conv_features:
            side = _conv_out(side)
        self.proj = nn.Linear(side * side * chans[-1], emb_dim)
        if generator is not None:
            for conv in self.convs:  # torch's default conv init, from the generator
                nn.init.kaiming_uniform_(conv.weight, a=5 ** 0.5, generator=generator)
                bound = (conv.in_channels * _KERNEL * _KERNEL) ** -0.5
                nn.init.uniform_(conv.bias, -bound, bound, generator=generator)
            nn.init.xavier_normal_(self.proj.weight, generator=generator)
            nn.init.zeros_(self.proj.bias)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """v: (batch, time, H, W) -> (batch, time, emb_dim)."""
        b, t = v.shape[:2]
        h = v.reshape(b * t, 1, *v.shape[2:])
        for conv in self.convs:
            ph, pw = same_padding(h.shape[-2]), same_padding(h.shape[-1])
            h = F.relu(conv(F.pad(h, (*pw, *ph))))
        return torch.tanh(self.proj(flatten_hwc(h).reshape(b, t, -1)))


class VideoVad(nn.Module):
    """Video-only frame VAD: lip encoder + stacked LSTM + sigmoid head."""

    def __init__(self, hidden: int = 512, num_layers: int = 2, emb_dim: int = 128,
                 conv_features: Sequence[int] = (8, 16, 32),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lip = LipEncoder(emb_dim, conv_features, generator)
        self.lstm = nn.LSTM(emb_dim, hidden, num_layers, batch_first=True)
        self.head = nn.Linear(hidden, 1)
        init_lstm_head(self.lstm, self.head, generator)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """v: (batch, time, H, W) -> per-frame VAD probability (batch, time)."""
        h, _ = self.lstm(self.lip(v))
        return torch.sigmoid(self.head(h)[..., 0])


class AVVad(nn.Module):
    """Audio-visual frame VAD: [log-power frames ; lip embedding] -> LSTM."""

    def __init__(self, x_dim: int = 513, hidden: int = 512, num_layers: int = 2,
                 emb_dim: int = 128, conv_features: Sequence[int] = (8, 16, 32),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lip = LipEncoder(emb_dim, conv_features, generator)
        self.lstm = nn.LSTM(x_dim + emb_dim, hidden, num_layers, batch_first=True)
        self.head = nn.Linear(hidden, 1)
        init_lstm_head(self.lstm, self.head, generator)

    def forward(self, xs) -> torch.Tensor:
        """xs = (audio (batch, time, x_dim), video (batch, time, H, W)) ->
        per-frame VAD probability (batch, time)."""
        a, v = xs
        h, _ = self.lstm(torch.cat([a, self.lip(v)], dim=-1))
        return torch.sigmoid(self.head(h)[..., 0])
