"""Synthetic data of the port (numpy copies of the JAX package's
generators; the LM and graph pipelines wait for ROADMAP item 7)."""
