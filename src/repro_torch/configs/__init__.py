"""Model configurations of the port: plain copies of the JAX package's
numbers (no dry-run bundles)."""
