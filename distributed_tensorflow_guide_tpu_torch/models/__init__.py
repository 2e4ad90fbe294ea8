"""The Transformer and its generator."""
