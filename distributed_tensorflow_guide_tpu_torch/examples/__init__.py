"""The example family: one runnable script per JAX ``examples/`` script,
with its file name and flags, on the port. Each runs as ``python -m
distributed_tensorflow_guide_tpu_torch.examples.<name>`` or as a file
under ``python -m distributed_tensorflow_guide_tpu_torch.launch``; its
body ``run(args)`` returns a summary dict (``_common.py``)."""
