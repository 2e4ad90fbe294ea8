"""distributed_tensorflow_guide_tpu_torch — the PyTorch/CUDA port of
``distributed_tensorflow_guide_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its module
paths and names and is written in PyTorch's idiom. Entry points run on
the first CUDA card unless the caller asks for ``device="cpu"``
(``core/device.py``); every kernel the JAX package wrote in Pallas is a
kernel written by hand for Hopper (``ops/csrc/``), with a plain PyTorch
version beside it for the CPU.

Package layout (slices 1-3: the GPT-2 serving path, the training step,
the process mesh and sequence parallelism; slice 7: the non-LM judged
configs; slice 8: tensor and pipeline parallelism; slice 9: FSDP, the
bucketed all-reduce, Megatron sequence parallelism, the async-PS
family):
    core/        device resolution, the process group's bootstrap
                 (dist), the process mesh, precision
    collectives/ psum / pmean / ppermute / all_to_all ... over a mesh axis,
                 with a comm trace
    runtime/     the multi-rank process runner; launch: the CLI launcher
    ops/         decode-attention kernels K5/K6 and flash-attention kernels
                 K1-K4 (CUDA) with their plain versions; blockwise
                 attention; the chunked fused cross-entropy
    data/        synthetic datasets (MNIST, ImageNet, click-through)
    models/      Transformer (training, contiguous-decode and paged views,
                 a classification head: BERT), the LM and classification
                 losses, the one-shot generator and samplers; ResNet with
                 flax's BatchNorm, the MNIST CNN, Wide&Deep
    parallel/    data parallelism over a mesh axis (bucketed all-reduce:
                 overlap), FSDP, tensor parallelism (Megatron SP),
                 pipeline parallelism, sequence parallelism (ring
                 attention, Ulysses), LocalSGD / GossipSGD /
                 AccumulatedAdaptive and the async-PS emulator, gradient
                 accumulation
    train/       TrainState, hooks, TrainLoop, held-out evaluation
    serve/       paged pool, scheduler, prefix index, engine, CLI
    obs/         flight recorder (copied)
    utils/       dispatch accounting, matmul and convolution FLOPs
    bridge       flax param trees <-> state dicts, numpy in and out
"""

__version__ = "0.1.0"
