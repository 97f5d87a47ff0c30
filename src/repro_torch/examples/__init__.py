"""The port's user surface, run as ``python -m repro_torch.examples.<name>``."""
