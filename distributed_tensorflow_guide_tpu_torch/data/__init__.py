"""Synthetic datasets (numpy, NHWC images)."""
