"""Device resolution and process helpers."""
