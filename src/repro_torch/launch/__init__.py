"""Entry points run as programs: ``python -m repro_torch.launch.serve``."""
