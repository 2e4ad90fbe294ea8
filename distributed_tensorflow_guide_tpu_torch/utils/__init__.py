"""Utilities: dispatch accounting, matmul and convolution FLOPs."""
