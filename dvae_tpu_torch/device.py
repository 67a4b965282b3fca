"""Device resolution for the port's entry points.

Counterpart of ``dvae_tpu.utils.misc.on_tpu``: the entry points run on the
card unless the caller asks for the CPU, and never drift onto the CPU by
themselves.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for explicitly.

    Raises RuntimeError when CUDA is wanted (explicitly or by default) but no
    CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
