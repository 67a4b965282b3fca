"""Command-line entry points of the port (``python -m dvae_tpu_torch.cli.<name>``)."""
