"""The port's client of the JAX package's API server, on its JSON and
stream wires."""
