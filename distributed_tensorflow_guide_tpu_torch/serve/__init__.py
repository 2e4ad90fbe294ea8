"""Continuous-batching serving: paged KV pool, request scheduler, prefix
index and the two step functions (``serve/engine.py``).

Import the modules directly (``serve.engine``, ``serve.paged_cache``):
this package imports nothing at load, because ``models/transformer.py``
and ``ops/decode_attention.py`` import ``serve.paged_cache``.
"""
