"""Drivers of the JAX package's examples on the port:
``python -m repro_torch.examples.quickstart``."""
