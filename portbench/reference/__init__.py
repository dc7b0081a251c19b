"""Plain NumPy / PyTorch reference of the retrieval service.

Frozen copies of the recipes the benchmark needs to make its inputs and
to judge the port's outputs: the synthetic corpus and query log, the
impact-ordered index, the 70 static features, the forest cascade (fit
and predict), score-at-a-time accumulation, pool selection, the
second-stage mixture and rerank, and MED-RBP for the envelope labels.
Nothing here imports the port, JAX or the JAX package.
"""
