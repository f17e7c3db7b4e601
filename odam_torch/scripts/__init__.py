"""Command-line entry points, run as ``python -m odam_torch.scripts.<name>``."""
