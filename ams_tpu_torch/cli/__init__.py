"""Command-line entry points of the port (``python -m
ams_tpu_torch.cli.run``)."""
