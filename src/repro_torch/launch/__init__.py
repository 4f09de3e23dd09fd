"""Long-lived entry points: ``python -m repro_torch.launch.serve``."""
