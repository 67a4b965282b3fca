"""PyTorch/CUDA port of ``dvae_tpu`` for one NVIDIA H100.

The JAX package ``dvae_tpu`` stays the reference; this package imports
nothing of it (nor JAX). Plain tensor code is PyTorch; the one TPU kernel on
the enhancement path, the Metropolis-Hastings chain, is a hand-written CUDA
kernel (``csrc/mh_chain.cu``), built with ``nvcc`` at first use.

Float32 throughout: TF32 is switched off for matmuls and cuDNN here, at
import, because ``log()`` in the spectrogram and MCEM energies amplifies the
~1e-3 relative error TF32 would put into every product (the JAX package uses
``Precision.HIGHEST`` for the same reason).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from dvae_tpu_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
