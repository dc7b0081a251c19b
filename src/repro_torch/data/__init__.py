"""Synthetic data of the port (numpy copies of the JAX package's
generators: the recsys logs, the LM token stream and the GraphSAGE
graphs)."""
