"""Parallel strategies: data parallelism over a mesh axis, gradient
accumulation, sequence parallelism."""
