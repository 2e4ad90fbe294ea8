"""Parallel strategies: single-device data parallelism so far."""
