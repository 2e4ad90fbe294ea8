"""Utilities: dispatch accounting."""
