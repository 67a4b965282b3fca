"""Audio LSTM voice-activity classifier (port of
``dvae_tpu.models.lstm_vad``): a stacked LSTM over per-frame
log-power-spectrogram features and a sigmoid frame-VAD head.

The module runs over all frames, padding included; the sequence trainer
masks padded frames out of every reduction. The recurrence is
``nn.LSTM``, which runs on cuDNN on the card; the package turns cuDNN's
TF32 off at import, so it runs in float32 (see ``dvae_tpu_torch``). The
gates are torch's i, f, g, o with a zero initial state, as the Flax
``OptimizedLSTMCell``'s are; ``models.convert.lstm_vad_state_dict_from_jax``
maps Flax weights onto it. The Flax cell has one bias per gate, on the
recurrent projection, so ``bias_ih_l*`` is held at zero and not trained:
two trained biases would move each gate's bias twice as fast under Adam.
"""

from __future__ import annotations

import torch
from torch import nn


class LSTMVad(nn.Module):
    def __init__(self, x_dim: int = 513, hidden: int = 1024, num_layers: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lstm = nn.LSTM(x_dim, hidden, num_layers, batch_first=True)
        self.head = nn.Linear(hidden, 1)
        if generator is not None:
            # torch's own default init, drawn from the given generator
            bound = hidden ** -0.5
            for p in self.lstm.parameters():
                nn.init.uniform_(p, -bound, bound, generator=generator)
            nn.init.xavier_normal_(self.head.weight, generator=generator)
            nn.init.zeros_(self.head.bias)
        for i in range(num_layers):
            b = getattr(self.lstm, f"bias_ih_l{i}")
            nn.init.zeros_(b)
            b.requires_grad_(False)

    def forward(self, x):
        """x: (batch, time, x_dim) -> per-frame VAD probability (batch, time)."""
        h, _ = self.lstm(x)
        return torch.sigmoid(self.head(h)[..., 0])
