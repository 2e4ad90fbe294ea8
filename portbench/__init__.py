"""The benchmark of the PyTorch and CUDA port (``distributed_tensorflow_guide_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once; ``BENCHMARK.json`` at the root of the checkout lists the cells.
"""
