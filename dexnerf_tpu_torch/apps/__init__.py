"""Command-line entry points (``python -m dexnerf_tpu_torch.apps.<name>``)."""
