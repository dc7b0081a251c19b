"""Checkpoints in the JAX package's on-disk format and the resilient
training driver (elastic restore waits for ROADMAP item 7)."""
