"""Model layers and the recsys models (the funnel's, and those trained by
``launch.train``).

Parameters are plain dictionaries (and lists) of tensors, laid out as the
JAX package's parameter trees, so a tree built by either package carries
across with ``repro_torch.convert``.  Initialisers draw from
``np.random.default_rng(seed)`` in the JAX package's order and give the
same numbers.
"""
