"""Command-line entry points of the port (``python -m fots_torch.cli.<name>``)."""
