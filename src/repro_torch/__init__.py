"""PyTorch/CUDA port of the dynamic trade-off retrieval system.

The JAX package ``repro`` is the reference; this package keeps its module
and function names so each counterpart is easy to find.  It imports
``torch`` and ``numpy`` only.  Entry points take an explicit ``device``
that defaults to ``"cuda"`` and raise when no card is present
(``device.resolve_device``); the CPU is used only when asked for.
"""
