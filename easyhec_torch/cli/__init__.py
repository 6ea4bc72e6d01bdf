"""Command-line entry points (``python -m easyhec_torch.cli.<name>``)."""
