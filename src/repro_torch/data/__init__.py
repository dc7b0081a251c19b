"""Synthetic data of the port (numpy copies of the JAX package's
generators: the recsys logs and the LM token stream; the graph pipeline
waits for ROADMAP item 7e)."""
