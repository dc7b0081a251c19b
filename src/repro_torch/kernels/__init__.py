"""Hand-written Hopper kernels of the port: ``impact_scan``, ``topk``,
``flash_attention`` and ``embedding_bag``.

Each kernel package keeps the JAX package's layout: ``kernel.py`` (the
CUDA launch, its plain torch version and a launch counter), ``ops.py``
(the contract callers use) and ``ref.py`` (the oracle).  CUDA sources
live in ``repro_torch/csrc`` and are built by ``_build`` at first use.
"""
