"""The port's client of the JAX package's API server (JSON wire)."""
