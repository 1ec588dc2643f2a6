"""Command-line entry points, run as `python -m setok_tpu_torch.scripts.<name>`."""
