"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``run.py`` is the entry point; everything a configuration, a traffic
mix or a per-layer metric needs lives in a file of its own under
``configs/``, ``workloads/`` and ``metrics/``, found by the names in
``BENCHMARK.json``.  ``reference/`` is the plain implementation that
decides ``correct``; it imports nothing of the port.
"""
