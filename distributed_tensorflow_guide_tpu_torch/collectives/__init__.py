from distributed_tensorflow_guide_tpu_torch.collectives.collectives import (  # noqa: F401
    CommTrace,
    all_gather,
    all_to_all,
    axis_size,
    pmax,
    pmean,
    ppermute,
    psum,
    reduce_scatter,
    ring_shift,
    trace_comm,
)
