"""distributed_tensorflow_guide_tpu_torch — the PyTorch/CUDA port of
``distributed_tensorflow_guide_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its module
paths and names and is written in PyTorch's idiom. Entry points run on
the first CUDA card unless the caller asks for ``device="cpu"``
(``core/device.py``); every kernel the JAX package wrote in Pallas is a
kernel written by hand for Hopper (``ops/csrc/``), with a plain PyTorch
version beside it for the CPU.

Package layout (this slice: the GPT-2 serving path):
    core/    device resolution, retry helper
    ops/     decode-attention kernels K5/K6 (CUDA), their plain versions
    models/  Transformer (training, contiguous-decode and paged views),
             the one-shot generator and samplers
    serve/   paged pool, scheduler, prefix index, engine, CLI
    obs/     flight recorder (copied)
    bridge   flax param tree <-> state dict, numpy in and out
"""

__version__ = "0.1.0"
