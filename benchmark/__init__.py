"""The benchmark of the PyTorch and CUDA port (``dvae_tpu_torch``) on one H100: see README.md."""
