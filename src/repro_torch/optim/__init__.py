"""Optimizer of the port: AdamW, learning-rate schedules and the int8
gradient compression (``compression``: a library, as in the JAX
package; no CLI flag uses it)."""
