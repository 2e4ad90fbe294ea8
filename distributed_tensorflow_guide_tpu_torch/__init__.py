"""distributed_tensorflow_guide_tpu_torch — the PyTorch/CUDA port of
``distributed_tensorflow_guide_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its module
paths and names and is written in PyTorch's idiom. Entry points run on
the first CUDA card unless the caller asks for ``device="cpu"``
(``core/device.py``); every kernel the JAX package wrote in Pallas is a
kernel written by hand for Hopper (``ops/csrc/``), with a plain PyTorch
version beside it for the CPU.

Package layout (slices 1-2: the GPT-2 serving path and training step):
    core/      device resolution, retry helper, is_chief, precision
    ops/       decode-attention kernels K5/K6 and flash-attention kernels
               K1-K3 (CUDA) with their plain versions; blockwise attention;
               the chunked fused cross-entropy
    models/    Transformer (training, contiguous-decode and paged views),
               the LM loss, the one-shot generator and samplers
    parallel/  the single-process data-parallel step, gradient accumulation
    train/     TrainState, hooks, TrainLoop
    serve/     paged pool, scheduler, prefix index, engine, CLI
    obs/       flight recorder (copied)
    utils/     dispatch accounting
    bridge     flax param tree <-> state dict, numpy in and out
"""

__version__ = "0.1.0"
