"""Process supervision: the multi-rank runner the tests and
``chip_smoke.py`` start their ranks with."""
