"""Checkpoints in the JAX package's on-disk format and the resilient
training driver (the elastic restore onto any mesh is ``distrib.elastic``)."""
