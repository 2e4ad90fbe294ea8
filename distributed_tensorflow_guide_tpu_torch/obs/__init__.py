"""Observability: the flight recorder (a copy of the JAX package's)."""
