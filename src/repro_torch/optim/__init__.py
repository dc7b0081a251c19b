"""Optimizer of the port: AdamW and learning-rate schedules (the JAX
package's int8 gradient compression waits for ROADMAP item 7)."""
